"""Device-resident paged KV cache with generation-stamped slots,
refcounted shared-prefix pages, and optional int8 or fp8 pools
(counterpart of ``mxnet_tpu/serving/decode/kv_cache.py``).

The decode batch's attention state lives on the device as page pools per
cache: ``k_pages`` / ``v_pages`` of shape ``(layers, num_pages,
page_size, heads, head_dim)``.  A sequence owns a *slot* and a fixed-length
page table (``max_pages_per_seq`` entries, padded with the reserved trash
page 0) mapping logical token positions to physical pages.  Page 0 is never
allocated: padded batch rows and padded prompt positions scatter their K/V
there, so one shape per batch bucket serves every batch composition.

Every slot carries a recycle generation, bumped on :meth:`free`; a
:class:`KVSlot` snapshots it at allocation (:meth:`generation`,
:meth:`page_generation`).  The JAX package's ``MXNET_SANITIZE=slots``
read fence over these stamps and its ``decode.kv_alloc`` fault site are
ROADMAP queue 1 item 10 and not ported.

**Prefix sharing** (``prefix_sharing=True``, the default): pages are
refcounted; at prefill commit the scheduler publishes each fully written
prompt page under a position-chained content hash (:meth:`publish`).  A
later :meth:`alloc` carrying the prompt acquires the longest published
chain by refcount instead of refilling it, and a whole-prompt match also
hands back the cached last-position logits, so admission skips the
prefill.  The one written boundary page (a prompt's partial tail) is
copied on write (:meth:`ensure_writable`, :meth:`_copy_page`).  Published
pages are pinned by the index and reclaimed LRU-first under allocation
pressure.

**Quantized pools**: ``kv_dtype="int8"`` stores int8 values with per-row
fp32 ``(scale, mid)`` sidecars of shape ``(layers, num_pages,
page_size)``; ``kv_dtype="fp8_e4m3"`` stores ``float8_e4m3fn`` values with
one ``scale`` sidecar per pool.  Quantization is row-stable, so the
shared-vs-cold bitwise contract holds in every pool dtype.

The pools are torch tensors on ``device`` (the current context, the GPU,
unless the caller asks for the CPU) and are updated in place.  A ``mesh``
(the JAX cache's heads-sharded pools) raises: sharding is ROADMAP queue 1
item 9.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ...context import as_device
from ...ops.paged_attention import pool_bytes
from ...telemetry import bus as _tel

__all__ = ["PagedKVCache", "KVSlot", "KVCacheExhausted", "pages_needed"]

TRASH_PAGE = 0


def pages_needed(prompt_len, max_new_tokens, page_size):
    """Pages a request reserves at admission.  Written positions are the
    prompt (``0..n-1``) plus every generated token that is fed back
    (``n..n+max_new-2`` — the last sampled token is returned, never
    re-encoded), so the reservation covers ``n + max_new - 1`` positions."""
    written = int(prompt_len) + max(int(max_new_tokens) - 1, 0)
    return -(-max(written, 1) // int(page_size))


class KVCacheExhausted(RuntimeError):
    """Not enough free pages (or slots) to admit a sequence right now.

    The scheduler treats this as backpressure — the request waits for
    evictions — unless the request could never fit, in which case it is
    shed with ``reason="kv_exhausted"``.  ``reclaimable`` counts pages
    pinned only by the shared-prefix index at raise time (already-reclaimed
    pages are in ``free``): a persistently non-zero value under shedding
    means the pool is sized for the prefix cache, not the live load."""

    def __init__(self, need, free, what="pages", reclaimable=0):
        msg = f"KV cache exhausted: need {need} {what}, {free} free"
        if what == "pages":
            msg += (f", {reclaimable} reclaimable from the shared-prefix "
                    f"cache")
        super().__init__(msg)
        self.need = need
        self.free = free
        self.reclaimable = reclaimable


class KVSlot:
    """A sequence's handle on its cache residency: slot id, generation
    stamp, and the fixed-length page table (padded with the trash page).

    With prefix sharing the first ``shared_pages`` entries are refcounted
    pages acquired from the prefix index (read-only for this sequence);
    ``page_gens`` stamps each held page's recycle generation (checked by
    the sanitizer of ROADMAP item 10), and a full-prompt hit carries
    ``prefix_logits``
    — the cached last-position logits that let admission skip prefill."""

    __slots__ = ("slot_id", "generation", "pages", "page_table",
                 "shared_pages", "page_gens", "prefix_logits")

    def __init__(self, slot_id, generation, pages, max_pages,
                 shared_pages=0, page_gens=None):
        self.slot_id = slot_id
        self.generation = generation
        self.pages = list(pages)
        self.page_table = list(self.pages) + \
            [TRASH_PAGE] * (max_pages - len(self.pages))
        self.shared_pages = int(shared_pages)
        self.page_gens = list(page_gens) if page_gens is not None \
            else [0] * len(self.pages)
        self.prefix_logits = None

    def write_table(self):
        """The prefill commit's scatter table: shared prefix pages are
        masked to the trash page (their content is already committed and
        read-only), so a partial-hit prefill stores only its own pages."""
        table = list(self.page_table)
        for i in range(self.shared_pages):
            table[i] = TRASH_PAGE
        return table

    def __repr__(self):
        return (f"KVSlot(id={self.slot_id}, gen={self.generation}, "
                f"pages={len(self.pages)}, shared={self.shared_pages})")


class _FullEntry:
    """One published full prompt: the canonical chain pages, an optional
    index-owned immutable copy of the partial tail page, the cached
    last-position logits, and the prompt length."""

    __slots__ = ("pages", "tail", "logits", "prompt_len")

    def __init__(self, pages, tail, logits, prompt_len):
        self.pages = tuple(pages)
        self.tail = tail
        self.logits = logits
        self.prompt_len = prompt_len


class PagedKVCache:
    """Fixed page pool + slot allocator for one decode runtime.

    Parameters
    ----------
    num_layers, num_heads, head_dim : int
        K/V geometry (must match the model).
    page_size : int
        Tokens per page.
    num_pages : int
        Total pages *including* the reserved trash page 0; usable
        capacity is ``num_pages - 1``.
    max_pages_per_seq : int
        Page-table length — fixes the decode step's gathered context at
        ``max_pages_per_seq * page_size`` tokens (the model's effective
        context window; constant shape = one shape per batch bucket).
    max_slots : int
        Concurrent-sequence bound (the scheduler's max batch bucket).
    dtype : str
        Compute dtype of the K/V values (fp32 pools store this directly).
    kv_dtype : str
        ``"float32"``/``"fp32"`` (default), ``"int8"`` or ``"fp8_e4m3"``:
        the *storage* dtype of the pools.  int8 adds per-row scale and mid
        sidecars, fp8 a per-row scale; the attention kernel dequantises in
        its loads.
    prefix_sharing : bool
        Refcount + content-hash prompt pages across sequences (default
        on).  Off, :meth:`alloc` ignores ``prompt`` and behaves exactly
        like the unshared allocator.
    prefix_entries : int
        LRU cap on published full-prompt entries.
    mesh : optional
        Not ported: sharded pools are ROADMAP queue 1 item 9; raises.
    device : optional
        Where the pools live; ``None`` means the current context (the
        GPU).
    """

    def __init__(self, num_layers, num_heads, head_dim, page_size=16,
                 num_pages=64, max_pages_per_seq=8, max_slots=16,
                 dtype="float32", kv_dtype=None, prefix_sharing=True,
                 prefix_entries=256, mesh=None, kv_axis="model",
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded KV cache is ROADMAP queue 1 item 9 (parallel "
                "and kvstore), not ported yet")
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is trash)")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.max_slots = int(max_slots)
        self.context_length = self.max_pages_per_seq * self.page_size
        self.dtype = str(dtype)
        kv_dtype = self.dtype if kv_dtype is None else str(kv_dtype)
        kv_dtype = {"fp32": "float32", "float": "float32",
                    "fp8": "fp8_e4m3", "float8_e4m3fn": "fp8_e4m3"}.get(
            kv_dtype, kv_dtype)
        if kv_dtype not in ("float32", "int8", "fp8_e4m3"):
            raise ValueError(
                f"kv_dtype must be 'float32', 'int8' or 'fp8_e4m3', "
                f"got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype in ("int8", "fp8_e4m3")
        # sidecar arity: int8 carries per-row (scale, mid) for K and V;
        # fp8 e4m3 keeps sign+mantissa so a per-row scale alone suffices
        self.num_sidecars = {"float32": 0, "int8": 4, "fp8_e4m3": 2}[
            kv_dtype]
        self.prefix_sharing = bool(prefix_sharing)
        self._prefix_entry_cap = int(prefix_entries)
        shape = (self.num_layers, self.num_pages, self.page_size,
                 self.num_heads, self.head_dim)
        if self.dtype not in ("float32", "fp32", "float"):
            raise ValueError(f"the decode model computes in float32, got "
                             f"dtype={dtype!r}")
        self.dtype = "float32"
        pool_dtype = {"float32": torch.float32, "int8": torch.int8,
                      "fp8_e4m3": torch.float8_e4m3fn}[kv_dtype]
        self.device = as_device(device)
        self.k_pages = torch.zeros(shape, dtype=pool_dtype,
                                   device=self.device)
        self.v_pages = torch.zeros(shape, dtype=pool_dtype,
                                   device=self.device)
        # (k_scale, k_mid, v_scale, v_mid) in int8, (k_scale, v_scale) in
        # fp8, empty in fp32
        self._quant = tuple(
            torch.zeros(shape[:3], dtype=torch.float32, device=self.device)
            for _ in range(self.num_sidecars))
        self._lock = threading.Lock()
        self._free_pages = list(range(1, self.num_pages))  # 0 = trash
        self._free_slots = list(range(self.max_slots))
        self._gen = [0] * self.max_slots
        self._live = {}          # slot_id -> KVSlot
        # --- refcounted shared-prefix state -------------------------------
        self._slot_refs = [0] * self.num_pages   # live-slot holders
        self._pin_refs = [0] * self.num_pages    # prefix-index holders
        self._page_gen = [0] * self.num_pages    # bumped on recycle
        self._prefix_pages = OrderedDict()       # chain hash -> page (LRU)
        self._page_hash = {}                     # page -> chain hash
        self._chain_parent = {}                  # chain hash -> prev hash
        self._chain_children = {}                # chain hash -> {next hashes}
        self._full_index = OrderedDict()         # prompt hash -> _FullEntry
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cow_copies = 0
        self.peak_pages = 0

    # ------------------------------------------------------------ geometry
    @property
    def usable_pages(self):
        return self.num_pages - 1

    @property
    def kv_bytes_per_token(self):
        """Device bytes one token position costs across K+V pools (all
        layers), including the int8 scale/zero sidecars."""
        row = self.num_heads * self.head_dim
        if self.kv_dtype == "int8":
            per_layer = 2 * (row + 2 * 4)    # int8 values + scale/mid f32
        elif self.kv_dtype == "fp8_e4m3":
            per_layer = 2 * (row + 4)        # fp8 values + scale f32
        else:
            per_layer = 2 * row * 4
        return self.num_layers * per_layer

    @property
    def page_bytes(self):
        """Device bytes one page costs (K+V, all layers, sidecars)."""
        return self.kv_bytes_per_token * self.page_size

    @property
    def pools(self):
        """Every device pool the commit, step and verify update in place:
        ``(k, v)`` in fp32, ``(k, v, k_scale, k_mid, v_scale, v_mid)`` in
        int8, ``(k, v, k_scale, v_scale)`` in fp8_e4m3."""
        return (self.k_pages, self.v_pages) + self._quant

    def set_pools(self, arrays):
        arrays = tuple(arrays)
        self.k_pages, self.v_pages = arrays[0], arrays[1]
        self._quant = arrays[2:]

    # ------------------------------------------------------------ occupancy
    @property
    def pages_in_use(self):
        """Pages held by live slots (prefix-cache pins are reported
        separately — see :meth:`stats` ``prefix_cached_pages``)."""
        with self._lock:
            return sum(1 for r in self._slot_refs if r > 0)

    @property
    def slots_in_use(self):
        with self._lock:
            return self.max_slots - len(self._free_slots)

    def fits_ever(self, n_pages):
        """Could a reservation of ``n_pages`` EVER be satisfied (empty
        cache)?  False means the request must be shed, not queued.
        Index-pinned pages are reclaimable, so they never shrink this."""
        return n_pages <= self.usable_pages

    def reclaimable_pages(self):
        """Pages held only by the shared-prefix index (no live slot) —
        what allocation pressure can reclaim right now."""
        with self._lock:
            return self._reclaimable_locked()

    def _reclaimable_locked(self):
        return sum(1 for p in range(1, self.num_pages)
                   if self._pin_refs[p] > 0 and self._slot_refs[p] == 0)

    # ------------------------------------------------------------- hashing
    def _page_hashes(self, prompt):
        """Position-chained content hashes of the prompt's *full* pages:
        ``h_i = H(h_{i-1} || tokens_of_page_i)`` — equal hashes mean equal
        tokens at equal positions, which (row-stable math) means bitwise
        equal committed K/V."""
        ps = self.page_size
        out, h = [], b"kv-chain-0"
        for i in range(len(prompt) // ps):
            h = hashlib.sha1(
                h + prompt[i * ps:(i + 1) * ps].tobytes()).digest()
            out.append(h)
        return out

    @staticmethod
    def _full_hash(prompt):
        return hashlib.sha1(
            b"kv-full" + np.int64(prompt.size).tobytes()
            + prompt.tobytes()).digest()

    # ------------------------------------------------------------ allocator
    def alloc(self, n_pages, prompt=None, site="decode.kv_alloc"):
        """Reserve ``n_pages`` + a slot; returns a generation-stamped
        :class:`KVSlot`.

        With ``prompt`` (int32 token array) and prefix sharing on, the
        published page chains are consulted first: matched pages are
        acquired by refcount instead of allocated, and a full-prompt match
        additionally hands back cached last-position logits
        (``slot.prefix_logits``) plus a private copy of the prompt's
        partial tail page — admission without a prefill.  Raises
        :class:`KVCacheExhausted` when the pool can't satisfy the
        reservation *right now*, after reclaiming LRU index-pinned pages.
        ``site`` names the caller (the JAX package's fault site and
        sanitizer registration, ROADMAP queue 1 item 10)."""
        n_pages = int(n_pages)
        if n_pages > self.max_pages_per_seq:
            raise ValueError(
                f"{n_pages} pages exceed max_pages_per_seq="
                f"{self.max_pages_per_seq} (context "
                f"{self.context_length} tokens)")
        use_prefix = (self.prefix_sharing and prompt is not None)
        if use_prefix:
            prompt = np.ascontiguousarray(np.asarray(prompt, "int32"))
        tail_copy = None           # (src_page, dst_page) pending device copy
        with self._lock:
            if not self._free_slots:
                raise KVCacheExhausted(1, 0, what="slots")
            shared, entry, fh = [], None, None
            if use_prefix:
                fh = self._full_hash(prompt)
                entry = self._full_index.get(fh)
                if entry is not None:
                    self._full_index.move_to_end(fh)
                    shared = list(entry.pages)
                    for p in shared:
                        h = self._page_hash.get(p)
                        if h is not None:
                            self._prefix_pages.move_to_end(h)
                else:
                    for h in self._page_hashes(prompt):
                        p = self._prefix_pages.get(h)
                        if p is None:
                            break
                        self._prefix_pages.move_to_end(h)
                        shared.append(p)
            # acquire the matched pages BEFORE any reclaim: with
            # slot_refs still 0 the reclaimer could evict exactly the
            # pages just matched and re-issue them as writable fresh
            # pages, aliasing the shared prefix
            for p in shared:
                self._slot_refs[p] += 1
            tail_src = None
            n_fresh = n_pages - len(shared)
            if entry is not None and entry.tail is not None:
                n_fresh = max(n_fresh, 1)   # room for the private tail copy
                # keep-alive ref on the index's tail page: holds it
                # through reclaim and the device copy below (dropped
                # once the copy lands)
                tail_src = entry.tail
                self._slot_refs[tail_src] += 1
            if n_fresh > len(self._free_pages):
                self._reclaim_locked(
                    n_fresh, keep=(fh,) if entry is not None else ())
            if n_fresh > len(self._free_pages):
                # roll back the acquisitions (releasing any page whose
                # index pin was reclaimed above) before reporting
                for p in shared:
                    self._drop_slot_ref_locked(p)
                if tail_src is not None:
                    self._drop_slot_ref_locked(tail_src)
                # not a hit/miss lookup: the scheduler retries this alloc
                # at every boundary until pages free up, and counting each
                # retry would skew prefix_hit_rate
                raise KVCacheExhausted(
                    n_pages, len(self._free_pages),
                    reclaimable=self._reclaimable_locked())
            slot_id = self._free_slots.pop()
            fresh = [self._free_pages.pop() for _ in range(n_fresh)]
            pages = list(shared) + fresh
            if tail_src is not None:
                # the entry's tail page is the index's immutable copy —
                # give this sequence its own (copy-on-write at admission:
                # its first generated token writes into this page)
                tail_copy = (tail_src, fresh[0])
            for p in fresh:
                self._slot_refs[p] += 1
            slot = KVSlot(slot_id, self._gen[slot_id], pages,
                          self.max_pages_per_seq,
                          shared_pages=len(shared),
                          page_gens=[self._page_gen[p] for p in pages])
            if entry is not None:
                slot.prefix_logits = entry.logits
            self._live[slot_id] = slot
            if use_prefix:
                self._count_lookup_locked(bool(shared))
            in_use = self.num_pages - 1 - len(self._free_pages)
            self.peak_pages = max(self.peak_pages, in_use)
        if tail_copy is not None:
            self._copy_page(*tail_copy)
            with self._lock:
                # drop the temporary keep-alive ref on the source page
                self._drop_slot_ref_locked(tail_copy[0])
        self._gauge(in_use)
        return slot

    def _count_lookup_locked(self, hit):
        if hit:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        if _tel.enabled:
            _tel.count("decode.prefix_hits" if hit
                       else "decode.prefix_misses")
            _tel.gauge("decode.prefix_hit_rate", round(
                self.prefix_hits
                / (self.prefix_hits + self.prefix_misses), 4))

    def free(self, slot):
        """Drop a slot's references.  Bumps the slot generation FIRST —
        any handle stamped with the old generation is stale from this
        point on.
        A page returns to the pool — and its page generation bumps — only
        when its LAST holder (slot or prefix-index pin) lets go, so
        freeing one session of a shared prefix never invalidates the
        survivors.  Double-frees raise instead of corrupting the
        refcounts."""
        with self._lock:
            live = self._live.get(slot.slot_id)
            if live is not slot or self._gen[slot.slot_id] != slot.generation:
                raise ValueError(
                    f"double/foreign free of {slot!r} (current generation "
                    f"{self._gen[slot.slot_id]})")
            self._gen[slot.slot_id] += 1
            del self._live[slot.slot_id]
            for p in slot.pages:
                self._drop_slot_ref_locked(p)
            self._free_slots.append(slot.slot_id)
            in_use = self.num_pages - 1 - len(self._free_pages)
        self._gauge(in_use)

    def _release_locked(self, page):
        """A page's last holder let go: recycle it (generation bump =
        the stamp a stale page handle is told by)."""
        self._free_pages.append(page)
        self._page_gen[page] += 1

    def _drop_slot_ref_locked(self, page):
        self._slot_refs[page] -= 1
        if self._slot_refs[page] == 0 and self._pin_refs[page] == 0:
            self._release_locked(page)

    # ------------------------------------------------------- prefix index
    def publish(self, slot, prompt, logits_row=None):
        """Publish a freshly committed prompt's pages for sharing.

        Every fully-written prompt page not already in the index is
        pinned under its chain hash; with ``logits_row`` (the prompt's
        last-position logits) a full-prompt entry is added so an exact
        repeat skips prefill entirely.  A partial tail page is *copied*
        into an index-owned page first (the live sequence keeps writing
        its own tail — the index copy stays immutable), skipped silently
        when no free page is available."""
        if not self.prefix_sharing:
            return
        prompt = np.ascontiguousarray(np.asarray(prompt, "int32"))
        tail_copy = None
        with self._lock:
            hashes = self._page_hashes(prompt)
            chain, prev = [], None
            for i, h in enumerate(hashes):
                p = self._prefix_pages.get(h)
                if p is None:
                    p = slot.page_table[i]
                    if p == TRASH_PAGE:
                        return           # foreign slot shape; nothing to do
                    self._prefix_pages[h] = p
                    self._page_hash[p] = h
                    self._pin_refs[p] += 1
                    # chain links let eviction unpublish whole suffixes
                    # (h encodes its predecessor, so the parent of a
                    # published hash is the same across prompts)
                    self._chain_parent[h] = prev
                    if prev is not None:
                        self._chain_children.setdefault(prev, set()).add(h)
                chain.append(p)
                prev = h
            fh = self._full_hash(prompt)
            if logits_row is None or fh in self._full_index:
                self._gauge_prefix_locked()
                return
            tail = None
            if prompt.size % self.page_size:
                if not self._free_pages:
                    self._reclaim_locked(1)
                if not self._free_pages:
                    self._gauge_prefix_locked()
                    return               # no room for the tail copy: skip
                tail = self._free_pages.pop()
                tail_copy = (slot.page_table[len(hashes)], tail)
            entry = _FullEntry(chain, tail,
                               np.array(logits_row, "float32", copy=True),
                               prompt.size)
            self._full_index[fh] = entry
            for p in entry.pages:
                self._pin_refs[p] += 1
            if tail is not None:
                self._pin_refs[tail] += 1
            while len(self._full_index) > self._prefix_entry_cap:
                h, e = next(iter(self._full_index.items()))
                self._drop_full_locked(h)
            self._gauge_prefix_locked()
        if tail_copy is not None:
            self._copy_page(*tail_copy)

    def _drop_full_locked(self, fh):
        entry = self._full_index.pop(fh)
        for p in entry.pages:
            self._unpin_locked(p)
        if entry.tail is not None:
            self._unpin_locked(entry.tail)

    def _unpublish_page_locked(self, h):
        # unpublish the suffix first: links past ``h`` could never match
        # again once ``h`` is gone (alloc stops at the first missing
        # link), so leaving them pinned would just strand pages
        for child in list(self._chain_children.get(h, ())):
            if child in self._prefix_pages:
                self._unpublish_page_locked(child)
        self._chain_children.pop(h, None)
        parent = self._chain_parent.pop(h, None)
        if parent is not None:
            kids = self._chain_children.get(parent)
            if kids is not None:
                kids.discard(h)
                if not kids:
                    del self._chain_children[parent]
        page = self._prefix_pages.pop(h)
        del self._page_hash[page]
        # a broken chain invalidates every full entry that rides it
        for fh in [fh for fh, e in self._full_index.items()
                   if page in e.pages]:
            self._drop_full_locked(fh)
        self._unpin_locked(page)

    def _unpin_locked(self, page):
        self._pin_refs[page] -= 1
        if self._pin_refs[page] == 0 and self._slot_refs[page] == 0:
            self._release_locked(page)

    def _reclaim_locked(self, need_free, keep=()):
        """Evict LRU index state until ``need_free`` pages are free (or
        nothing reclaimable remains): full entries first (their private
        tail copies are pure cache), then whole published chains.
        ``keep`` full-entry hashes are exempt — the entry an in-flight
        alloc just matched must not be reclaimed out from under it.
        Unpublishing a chain link takes its whole suffix with it, so the
        surviving index state stays matchable."""
        for fh in list(self._full_index):
            if len(self._free_pages) >= need_free:
                break
            if fh in keep:
                continue
            self._drop_full_locked(fh)
        for h in list(self._prefix_pages):
            if len(self._free_pages) >= need_free:
                break
            if h not in self._prefix_pages:
                continue    # already gone as part of an earlier suffix
            if self._slot_refs[self._prefix_pages[h]] == 0:
                self._unpublish_page_locked(h)

    def drop_prefix_cache(self):
        """Unpublish everything: every index-only page returns to the
        pool (live slots keep theirs until freed).  The bench/ops
        "drop caches" lever, and how tests separate a leak from a pin."""
        with self._lock:
            for fh in list(self._full_index):
                self._drop_full_locked(fh)
            for h in list(self._prefix_pages):
                if h in self._prefix_pages:
                    self._unpublish_page_locked(h)
            in_use = self.num_pages - 1 - len(self._free_pages)
            self._gauge_prefix_locked()
        self._gauge(in_use)

    def _gauge_prefix_locked(self):
        if _tel.enabled:
            _tel.gauge("decode.kv_cached_pages",
                       sum(1 for p in range(1, self.num_pages)
                           if self._pin_refs[p] > 0))

    # ------------------------------------------------------- copy-on-write
    def ensure_writable(self, slot, page_idx):
        """Guarantee the slot exclusively owns the page it is about to
        write (``page_idx`` in its table): a shared or index-pinned page
        is replaced by a private copy first — THE copy-on-write trigger.
        By construction admission already privatized every write-path
        page, so this is a cheap per-step guard (two refcount reads)."""
        if not self.prefix_sharing or page_idx >= len(slot.pages):
            return
        page = slot.pages[page_idx]
        with self._lock:
            if self._slot_refs[page] <= 1 and self._pin_refs[page] == 0:
                return
            if not self._free_pages:
                self._reclaim_locked(1)
            if not self._free_pages:
                raise KVCacheExhausted(
                    1, 0, reclaimable=self._reclaimable_locked())
            fresh = self._free_pages.pop()
            self._slot_refs[fresh] += 1
            slot.pages[page_idx] = fresh
            slot.page_table[page_idx] = fresh
            slot.page_gens[page_idx] = self._page_gen[fresh]
            if page_idx < slot.shared_pages:
                slot.shared_pages = page_idx
        self._copy_page(page, fresh)
        with self._lock:
            # the slot's ref on the old page is dropped only AFTER the
            # device copy: releasing it inside the lock above would let
            # a concurrent reclaim recycle the copy's source page
            self._drop_slot_ref_locked(page)

    def _copy_page(self, src, dst):
        """Copy page ``src`` onto ``dst`` in every pool (values and
        sidecars), in place on the pools' stream."""
        with torch.no_grad():
            for p in self.pools:
                b = pool_bytes(p)
                b[:, dst].copy_(b[:, src])
        self.cow_copies += 1
        if _tel.enabled:
            _tel.count("decode.kv_cow_copies")

    def warm_programs(self):
        """Run the CoW copy once before traffic (trash -> trash: no
        allocated page is touched), as the runtime warms its buckets."""
        self._copy_page(TRASH_PAGE, TRASH_PAGE)
        self.cow_copies -= 1         # warming is not a CoW event

    # ---------------------------------------------------------- generations
    def generation(self, slot_id):
        """Current recycle generation of a slot."""
        with self._lock:
            return self._gen[slot_id]

    def page_generation(self, page):
        """Current recycle generation of a physical page, bumped only
        when the page's last holder (slot or index pin) releases it."""
        with self._lock:
            return self._page_gen[page]

    def _gauge(self, in_use):
        if _tel.enabled:
            _tel.gauge("decode.kv_occupancy",
                       round(in_use / max(self.usable_pages, 1), 4))
            _tel.gauge("decode.kv_pages", in_use)
            _tel.gauge("decode.kv_bytes_per_token", self.kv_bytes_per_token)

    def reset_peak(self):
        """Restart the ``peak_pages`` high-water mark (bench phases)."""
        with self._lock:
            self.peak_pages = self.num_pages - 1 - len(self._free_pages)

    def stats(self):
        with self._lock:
            slot_pages = sum(1 for r in self._slot_refs if r > 0)
            pinned = sum(1 for p in range(1, self.num_pages)
                         if self._pin_refs[p] > 0)
            lookups = self.prefix_hits + self.prefix_misses
            return {
                "pages_in_use": slot_pages,
                "usable_pages": self.usable_pages,
                "slots_in_use": self.max_slots - len(self._free_slots),
                "max_slots": self.max_slots,
                "peak_pages": self.peak_pages,
                "kv_dtype": self.kv_dtype,
                "kv_bytes_per_token": self.kv_bytes_per_token,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_rate": round(self.prefix_hits / lookups, 4)
                if lookups else 0.0,
                "prefix_cached_pages": pinned,
                "reclaimable_pages": self._reclaimable_locked(),
                "shared_pages": sum(
                    1 for p in range(1, self.num_pages)
                    if self._slot_refs[p] > 1
                    or (self._slot_refs[p] and self._pin_refs[p])),
                "cow_copies": self.cow_copies,
            }
