"""Speculative-decoding drafters — propose k tokens, verify in ONE step
(counterpart of ``mxnet_tpu/serving/decode/speculate.py``; host code,
unchanged but for its imports).

Classic autoregressive decode pays one full forward step per token.
Speculative decoding breaks the serialization: a cheap *drafter* proposes
``k`` continuation tokens and the target model scores all of them in a
single fused **verify** program (:meth:`DecodeRuntime.verify`) — the
accepted prefix commits ``m + 1`` tokens per step (the ``m`` matching
drafts plus the target's own sample at the first mismatch, or a *bonus*
token when everything matched) for the price of roughly one.

**Deterministic acceptance.**  This implementation does not use the
stochastic accept/reject of Leviathan-style speculative *sampling*.  The
verify program computes, per drafted position, the token the target model
WOULD have sampled anyway — same logits (causal-mask-extended paged
attention is bitwise the step program's math, by induction over offsets
and layers), same per-request ``fold_in(key, step_idx + j)`` Gumbel
stream — and accepts a draft token iff it *equals* that sample.  The
emitted stream is therefore **always bitwise-identical to non-speculative
decode** — greedy and sampled alike, solo or continuous-batched,
regardless of what the drafter proposed or how ``spec_k`` adapted.  The
draft only ever changes *speed* (tokens per step), never a single bit of
output.  That is the whole determinism contract, and CI asserts it.

Drafters
--------
:class:`NgramDrafter`
    Self-draft / prompt-lookup: find the most recent earlier occurrence
    of the context's own suffix n-gram and propose the tokens that
    followed it.  No extra model, no state, pure function of the
    request's committed tokens — ideal for repetitive or quoting
    workloads (code, retrieval, structured output).
:class:`ModelDrafter`
    A small :class:`CausalLM` running greedily through its own
    :class:`DecodeRuntime` + :class:`PagedKVCache` (the same paged
    machinery as the target).  Per boundary it catches up on tokens the
    target committed past its cache (at most one in steady state —
    accepted drafts were its own feeds) and then drafts ``k`` ahead,
    batched across every speculating row.

Both are *fallible by design*: any drafter error degrades the affected
rows to non-speculative for that boundary — requests never fail because
a draft could not be produced.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["Drafter", "NgramDrafter", "ModelDrafter", "SpecState"]

_EMPTY = np.zeros((0,), "int32")


def _context(req):
    """A request's committed token stream: prompt + generated ids.
    Token ``i`` of this array sits at cache position ``i``."""
    if req.tokens:
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens, "int32")])
    return req.prompt


class SpecState:
    """Per-request speculative state: the adaptive ``spec_k`` plus the
    windowed acceptance history that drives it.  Adaptation reads only
    the request's OWN history, so it is a pure function of (prompt,
    seed, temperature) — solo and continuous runs adapt identically."""

    __slots__ = ("k", "k_max", "window")

    def __init__(self, k, k_max, window=16):
        self.k = int(k)
        self.k_max = int(k_max)
        self.window = deque(maxlen=int(window))

    def observe(self, proposed, accepted):
        """Record one verify round and adapt ``k``: grow on a hot window
        (>= 80% accepted), shrink on a cold one (< 30%)."""
        if proposed <= 0:
            return
        self.window.append((int(proposed), int(accepted)))
        prop = sum(p for p, _ in self.window)
        acc = sum(a for _, a in self.window)
        if len(self.window) < 4 or prop == 0:
            return
        rate = acc / prop
        if rate >= 0.8 and self.k < self.k_max:
            self.k += 1
        elif rate < 0.3 and self.k > 1:
            self.k -= 1

    @property
    def acceptance_rate(self):
        prop = sum(p for p, _ in self.window)
        if not prop:
            return 0.0
        return sum(a for _, a in self.window) / prop


class Drafter:
    """Base drafter.  The scheduler calls :meth:`bind` once at
    construction, :meth:`attach` / :meth:`detach` per request lifecycle,
    :meth:`propose_batch` per step boundary, and :meth:`observe` after
    each verify commits.  All hooks default to no-ops so a drafter only
    implements what it needs."""

    name = "drafter"

    def bind(self, runtime):
        """Called once with the target :class:`DecodeRuntime`."""

    def attach(self, req):
        """A request was admitted (its prompt K/V is, or is about to be,
        paged in).  May raise — the scheduler degrades that request to
        non-speculative."""

    def detach(self, req):
        """The request left the batch (finished, failed, aborted).  Must
        tolerate requests never attached."""

    def observe(self, req, proposed, accepted):
        """One verify round committed: ``accepted`` of ``proposed``
        draft tokens matched (``req.position`` is already advanced)."""

    def propose(self, req, k):
        """Up to ``k`` drafted continuation tokens (int32 1-D array) for
        one request; empty means "don't speculate this boundary"."""
        return _EMPTY

    def propose_batch(self, reqs, ks):
        """Drafts for every active row (``ks[i] == 0`` rows must get an
        empty draft).  Default: per-row :meth:`propose`."""
        return [self.propose(req, k) if k > 0 else _EMPTY
                for req, k in zip(reqs, ks)]


class NgramDrafter(Drafter):
    """Prompt-lookup self-drafting: propose the continuation of the most
    recent earlier occurrence of the context's own trailing n-gram.

    Tries suffix lengths ``max_ngram .. min_ngram`` (longest match wins;
    among equal lengths the most recent occurrence with a FULL ``k``
    -token continuation wins, else the one with the longest continuation
    — an occurrence hugging the end of the context predicts almost
    nothing) and returns up to ``k`` following tokens.  Deterministic
    pure function of the committed context — identical solo vs
    continuous by construction."""

    name = "ngram"

    def __init__(self, max_ngram=3, min_ngram=1, window=128):
        if int(min_ngram) < 1 or int(max_ngram) < int(min_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}/{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.window = int(window)       # lookback cap: drafting is on
        #                                 every step boundary's hot path

    def propose(self, req, k):
        ctx = _context(req)
        if ctx.size > self.window:
            ctx = ctx[ctx.size - self.window:]
        n_hi = min(self.max_ngram, ctx.size - 1)
        for n in range(n_hi, self.min_ngram - 1, -1):
            suffix = ctx[ctx.size - n:]
            windows = np.lib.stride_tricks.sliding_window_view(
                ctx[:ctx.size - 1], n)
            hits = np.nonzero((windows == suffix).all(axis=1))[0]
            if hits.size:
                starts = hits[::-1] + n          # most recent first
                avail = ctx.size - starts
                full = starts[avail >= int(k)]
                start = int(full[0] if full.size
                            else starts[int(np.argmax(avail))])
                cont = ctx[start:start + int(k)]
                if cont.size:
                    return np.asarray(cont, "int32")
        return _EMPTY


class _DraftSlot:
    __slots__ = ("slot", "fed")

    def __init__(self, slot, fed):
        self.slot = slot
        self.fed = fed          # positions [0, fed) hold committed K/V


class ModelDrafter(Drafter):
    """Greedy draft model sharing the paged-KV machinery.

    ``block`` is a (smaller) initialized :class:`CausalLM` whose
    vocabulary matches the target's and whose position table covers the
    target's context.  :meth:`bind` builds a private
    :class:`DecodeRuntime` mirroring the target's serving geometry
    (batch buckets, seq buckets, page size) so catch-up and draft steps
    ride warmed per-bucket programs — the drafter obeys the same
    zero-steady-state-compile discipline as the target."""

    name = "model"

    def __init__(self, block, kv_dtype=None, num_pages=None):
        self.block = block
        self.kv_dtype = kv_dtype
        self.num_pages = num_pages
        self.runtime = None
        self._by_req = {}        # id(req) -> _DraftSlot

    def bind(self, runtime):
        if self.runtime is not None:
            return
        from .runtime import DecodeRuntime
        tgt = runtime
        if self.block.vocab_size != tgt.block.vocab_size:
            raise ValueError(
                f"draft vocab {self.block.vocab_size} != target vocab "
                f"{tgt.block.vocab_size}")
        if self.block.max_length < tgt.cache.context_length:
            raise ValueError(
                f"draft max_length {self.block.max_length} < target "
                f"context {tgt.cache.context_length}")
        self.runtime = DecodeRuntime(
            self.block, batch_buckets=tgt.batch_buckets,
            seq_buckets=tgt.seq_buckets,
            page_size=tgt.cache.page_size,
            num_pages=self.num_pages,
            max_slots=tgt.cache.max_slots,
            kv_dtype=self.kv_dtype, prefix_sharing=False,
            name=f"{tgt.name}-draft", warm=True)

    # ------------------------------------------------------- req lifecycle
    def attach(self, req):
        from .kv_cache import pages_needed
        rt = self.runtime
        cache = rt.cache
        n = pages_needed(req.prompt.size, req.max_new, cache.page_size)
        slot = cache.alloc(n, site="decode.draft_alloc")
        try:
            s = rt.seq_bucket_for(req.prompt.size)
            tokens = np.zeros((1, s), "int32")
            tokens[0, :req.prompt.size] = req.prompt
            rt.prefill(tokens, np.array([req.prompt.size], "int32"),
                       np.asarray(slot.page_table, "int32")[None],
                       np.zeros((1, 2), "uint32"),
                       np.zeros((1,), "float32"))
        except BaseException:
            cache.free(slot)
            raise
        self._by_req[id(req)] = _DraftSlot(slot, req.prompt.size)

    def detach(self, req):
        st = self._by_req.pop(id(req), None)
        if st is not None:
            self.runtime.cache.free(st.slot)

    def observe(self, req, proposed, accepted):
        """After a verify commit the draft cache holds committed K/V for
        the catch-up span, the re-fed current token and the accepted
        drafts (its own feeds); the first rejected draft's K/V is stale
        and will be re-fed next boundary."""
        st = self._by_req.get(id(req))
        if st is None or proposed <= 0:
            return
        pos_before = req.position - (accepted + 1)
        st.fed = pos_before + 1 + min(accepted, proposed - 1)

    # ------------------------------------------------------------ drafting
    def propose_batch(self, reqs, ks):
        out = [_EMPTY] * len(reqs)
        rows = [(i, req, int(k), self._by_req[id(req)])
                for i, (req, k) in enumerate(zip(reqs, ks))
                if k > 0 and id(req) in self._by_req]
        if not rows:
            return out
        rt = self.runtime
        cache = rt.cache
        b = rt.batch_bucket_for(len(rows))
        contexts = [_context(req) for _, req, _, _ in rows]
        feeds = [st.fed for _, _, _, st in rows]
        drafts = [[] for _ in rows]
        # micro-steps: each feeds one token per row — catch-up tokens
        # from the committed stream first (outputs ignored), then the
        # greedy draft chain.  Done rows ride on the trash table.
        n_micro = max((req.position - fed) + k
                      for (_, req, k, _), fed in zip(rows, feeds))
        tables = np.zeros((b, cache.max_pages_per_seq), "int32")
        keys = np.zeros((b, 2), "uint32")
        steps = np.zeros((b,), "int32")
        temps = np.zeros((b,), "float32")    # 0 = greedy draft
        for _ in range(n_micro):
            tokens = np.zeros((b,), "int32")
            positions = np.zeros((b,), "int32")
            live = False
            for r, ((_, req, k, st), ctx, dr) in enumerate(
                    zip(rows, contexts, drafts)):
                q = feeds[r] + len(dr)       # next position to feed
                if len(dr) >= k:
                    tables[r, :] = 0         # done: write trash
                    continue
                live = True
                tables[r] = st.slot.page_table
                positions[r] = q
                tokens[r] = (ctx[q] if q < ctx.size
                             else dr[q - ctx.size])
            if not live:
                break
            nxt = rt.step(tokens, positions, tables, keys, steps, temps)
            for r, ((_, req, k, st), ctx, dr) in enumerate(
                    zip(rows, contexts, drafts)):
                q = feeds[r] + len(dr)
                if len(dr) >= k:
                    continue
                if q < req.position:
                    feeds[r] += 1            # catch-up: output ignored
                else:
                    dr.append(int(nxt[r]))
        for (i, req, k, st), fed, dr in zip(rows, feeds, drafts):
            st.fed = fed
            out[i] = np.asarray(dr[:k], "int32")
        return out


def resolve_drafter(spec):
    """``None`` / a :class:`Drafter` / the strings ``"ngram"`` or a
    :class:`CausalLM` instance (wrapped in a :class:`ModelDrafter`)."""
    if spec is None or isinstance(spec, Drafter):
        return spec
    if isinstance(spec, str):
        if spec == "ngram":
            return NgramDrafter()
        raise ValueError(f"unknown drafter {spec!r} (want 'ngram', a "
                         f"Drafter, or a CausalLM draft model)")
    from .model import CausalLM
    if isinstance(spec, CausalLM):
        return ModelDrafter(spec)
    raise TypeError(f"cannot build a drafter from {type(spec)}")
