"""DecodeRuntime: the fixed-shape side of generative serving (counterpart
of ``mxnet_tpu/serving/decode/runtime.py``).

Decode has two surfaces with different shape disciplines:

- **Prefill** pads each prompt group to ``(batch_bucket, seq_bucket)``, a
  2-D grid run once at load through ``HybridBlock.compile_grid``; its
  *commit* scatters the emitted K/V into the cache pages (quantizing for an
  int8 or fp8 cache) and samples the first token.
- **The decode step** runs per *batch bucket*: write the new K/V into the
  pages, attend over the paged context, sample.  Sequence length never
  appears in its shape, so a handful of warmed shapes serves every
  request; a shape outside the warmed set is counted as
  ``decode.compile_miss``, which must stay zero in steady state across
  arbitrary joins and evictions.
- **The verify** (speculative decoding) runs per (batch bucket, spec
  bucket): ``k`` drafted tokens scored in one call.

The JAX runtime donates the pools to jitted programs; here the pools are
updated in place.  Placement: the block's device, which ``initialize``
made the current context (the GPU) unless the caller asked for the CPU.
The JAX runtime's persistent program cache (``aot_cache=``) is ROADMAP
queue 1 item 8's ``aot.py`` step and raises here.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.paged_attention import pool_bytes
from ...telemetry import bus as _tel
from .kv_cache import PagedKVCache
from .model import kv_quantize_rows, kv_quantize_rows_fp8
from .sampling import sample

__all__ = ["DecodeRuntime", "seq_bucket_ladder"]


def seq_bucket_ladder(max_seqlen, min_bucket=8):
    """Power-of-two sequence-length ladder capped at ``max_seqlen`` (the
    cap itself is always a bucket): the second axis of the prefill grid."""
    max_seqlen = int(max_seqlen)
    if max_seqlen < 1:
        raise ValueError(f"max_seqlen must be >= 1, got {max_seqlen}")
    ladder, b = [], max(int(min_bucket), 1)
    while b < max_seqlen:
        ladder.append(b)
        b *= 2
    ladder.append(max_seqlen)
    return tuple(sorted(set(ladder)))


class DecodeRuntime:
    """A :class:`~mxnet_tpu_torch.serving.decode.model.CausalLM` plus a
    :class:`PagedKVCache`, warmed over the prefill grid, the step buckets
    and the verify buckets described in the module docstring.

    Parameters are the JAX runtime's: ``block`` (an initialized
    ``CausalLM``), ``cache`` (built from the model's geometry when
    omitted, with ``page_size``/``num_pages``/``max_slots``/``kv_dtype``/
    ``prefix_sharing``), ``batch_buckets``, ``seq_buckets`` (default
    :func:`seq_bucket_ladder` over the cache's context), ``spec_buckets``
    (the verify ladder; empty for no speculative decoding), ``warm``.
    ``mesh`` and ``aot_cache`` raise (ROADMAP queue 1 items 9 and 8).
    """

    def __init__(self, block, cache=None, batch_buckets=(1, 2, 4, 8),
                 seq_buckets=None, page_size=16, num_pages=None,
                 max_slots=None, kv_dtype=None, prefix_sharing=True,
                 mesh=None, name=None, warm=True, aot_cache=None,
                 spec_buckets=()):
        if aot_cache is not None:
            raise NotImplementedError(
                "a persistent program cache is ROADMAP queue 1 item 8's "
                "aot.py step, not ported yet")
        if not getattr(block, "_active", False):
            block.hybridize()
        self._block = block
        self.device = block.device
        self.name = name or getattr(block, "name", "decode")
        self.batch_buckets = tuple(sorted(set(
            int(b) for b in batch_buckets)))
        if self.batch_buckets[0] < 1:
            raise ValueError(f"batch buckets {self.batch_buckets} must "
                             f"be >= 1")
        self.max_batch = self.batch_buckets[-1]
        if cache is None:
            # floor, not ceil: the derived context (max_pages * page_size)
            # must never exceed the model's position table
            max_pages = block.max_length // int(page_size)
            if max_pages < 1:
                raise ValueError(
                    f"page_size={page_size} exceeds the model's "
                    f"max_length={block.max_length}: no whole page fits "
                    f"the position table")
            cache = PagedKVCache(
                block.num_layers, block.num_heads, block.head_dim,
                page_size=page_size,
                num_pages=(num_pages if num_pages is not None
                           else max_pages * 2 * self.max_batch + 1),
                max_pages_per_seq=max_pages,
                max_slots=(max_slots if max_slots is not None
                           else 2 * self.max_batch),
                kv_dtype=kv_dtype, prefix_sharing=prefix_sharing,
                mesh=mesh, device=self.device)
        if cache.device != self.device:
            raise ValueError(f"the cache lives on {cache.device}, the model "
                             f"on {self.device}")
        if cache.context_length > block.max_length:
            raise ValueError(
                f"cache context {cache.context_length} exceeds the model's "
                f"position table ({block.max_length})")
        if cache.max_slots < self.max_batch:
            raise ValueError(
                f"cache max_slots={cache.max_slots} < largest batch "
                f"bucket {self.max_batch}")
        self.cache = cache
        self.seq_buckets = tuple(sorted(set(
            int(s) for s in (seq_buckets if seq_buckets is not None
                             else seq_bucket_ladder(cache.context_length)))))
        if self.seq_buckets[-1] > cache.context_length:
            raise ValueError(
                f"seq buckets {self.seq_buckets} exceed the cache context "
                f"({cache.context_length} tokens)")
        self.max_prompt_len = self.seq_buckets[-1]
        self.spec_buckets = tuple(sorted(set(
            int(k) for k in spec_buckets)))
        if self.spec_buckets and self.spec_buckets[0] < 1:
            raise ValueError(
                f"spec buckets {self.spec_buckets} must be >= 1")
        if self.spec_buckets and \
                self.spec_buckets[-1] >= cache.context_length:
            raise ValueError(
                f"spec bucket cap {self.spec_buckets[-1]} exceeds the "
                f"cache context ({cache.context_length} tokens)")
        self.max_spec_k = self.spec_buckets[-1] if self.spec_buckets else 0
        self._params = block._params_dict(block.param_leaves())
        # shapes run once: ("step", b), ("verify", (b, k)),
        # ("prefill", (b, s)) and ("sample_first", 1)
        self._seen = set()
        self._warmed = False
        if warm:
            self.warm()

    @property
    def block(self):
        return self._block

    # -------------------------------------------------------------- ladders
    def batch_bucket_for(self, n):
        for b in self.batch_buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds bucket cap {self.max_batch}")

    def seq_bucket_for(self, n):
        for s in self.seq_buckets:
            if s >= n:
                return s
        raise ValueError(
            f"prompt of {n} tokens exceeds the largest seq bucket "
            f"{self.max_prompt_len}")

    def spec_bucket_for(self, k):
        """Smallest verify-k bucket covering ``k`` drafted tokens."""
        for kb in self.spec_buckets:
            if kb >= k:
                return kb
        raise ValueError(
            f"draft of {k} tokens exceeds the spec bucket cap "
            f"{self.max_spec_k}")

    # --------------------------------------------------------------- warmup
    def warm(self):
        """Run the whole prefill grid, every step bucket and every verify
        bucket once before taking traffic, with all-trash page tables:
        every row scatters into the reserved trash page, so warming
        touches no allocated page."""
        grid = [(b, s) for b in self.batch_buckets for s in self.seq_buckets]
        with _tel.span("decode.warmup", model=self.name,
                       grid=len(grid), steps=len(self.batch_buckets)):
            def make_example(bs):
                b, s = bs
                return [torch.zeros((b, s), dtype=torch.int32,
                                    device=self.device),
                        torch.ones((b,), dtype=torch.int32,
                                   device=self.device)]

            self._block.compile_grid(make_example, grid)
            np_ = self.cache.max_pages_per_seq
            for b, s in grid:
                self.prefill(np.zeros((b, s), "int32"),
                             np.ones((b,), "int32"),
                             np.zeros((b, np_), "int32"),
                             np.zeros((b, 2), "uint32"),
                             np.zeros((b,), "float32"))
            for b in self.batch_buckets:
                self.step(np.zeros((b,), "int32"), np.zeros((b,), "int32"),
                          np.zeros((b, np_), "int32"),
                          np.zeros((b, 2), "uint32"),
                          np.zeros((b,), "int32"), np.zeros((b,), "float32"))
                for k in self.spec_buckets:
                    self.verify(np.zeros((b, k + 1), "int32"),
                                np.zeros((b,), "int32"),
                                np.zeros((b,), "int32"),
                                np.zeros((b, np_), "int32"),
                                np.zeros((b, 2), "uint32"),
                                np.zeros((b,), "int32"),
                                np.zeros((b,), "float32"))
            self.sample_first(
                np.zeros((self._block.vocab_size,), "float32"),
                np.zeros((2,), "uint32"), 0.0)
            if self.cache.prefix_sharing:
                self.cache.warm_programs()
        self._warmed = True
        if _tel.enabled:
            _tel.count("decode.warmup_compiles",
                       2 * len(grid) + len(self.batch_buckets)
                       * (1 + len(self.spec_buckets)),
                       model=self.name)

    def _note(self, kind, key):
        """Count a shape outside the warmed set once (``decode.compile_
        miss``, the JAX runtime's counter of cold programs)."""
        if (kind, key) in self._seen:
            return
        self._seen.add((kind, key))
        if self._warmed and _tel.enabled:
            _tel.count("decode.compile_miss", model=self.name, kind=kind)
            _tel.instant("decode.compile_miss", model=self.name, kind=kind,
                         bucket=str(key))

    def _ints(self, *arrays):
        """Host int arrays of one leading dimension, moved to the device in
        one copy; returns the device views in order."""
        b = arrays[0].shape[0]
        flat = [np.asarray(a, np.int64).reshape(b, -1) for a in arrays]
        dev = torch.from_numpy(np.concatenate(flat, axis=1)).to(
            self.device)
        out, at = [], 0
        for a, f in zip(arrays, flat):
            w = f.shape[1]
            out.append(dev[:, at:at + w].reshape(np.shape(a)))
            at += w
        return out

    # ------------------------------------------------------------ execution
    def prefill(self, tokens, lengths, tables, keys, temps):
        """Prefill and commit one padded prompt group (host arrays padded to
        a grid bucket; padded rows have length 1 and an all-trash table).
        Returns ``(first, logits)``: the sampled first token of each row
        (host int32) and, when the cache shares prefixes, the host copy of
        the last-position logits (``(B, vocab)`` float32) that the
        scheduler publishes with the prompt."""
        b, s = tokens.shape
        self._note("prefill", (b, s))
        cache = self.cache
        ps = cache.page_size
        tables = np.asarray(tables, np.int64)
        lengths = np.asarray(lengths, np.int64)
        j = np.arange(s)[None, :]
        valid = j < lengths[:, None]
        dest_page = np.where(
            valid, np.take_along_axis(tables, np.broadcast_to(
                j // ps, (b, s)), axis=1), 0)
        dest_off = np.broadcast_to(j % ps, (b, s))
        tok, ln, dpage, doff = self._ints(tokens, lengths, dest_page,
                                          dest_off)
        with _tel.span("decode.prefill", model=self.name, batch=b, seq=s):
            with torch.no_grad():
                logits, kv = self._block(tok.to(torch.int32),
                                         ln.to(torch.int32))
                self._commit(kv, dpage, doff)
                first = sample(logits, keys, np.zeros((b,), "int32"), temps)
                logits_host = (logits.float().cpu().numpy()
                               if cache.prefix_sharing else None)
        return first.cpu().numpy(), logits_host

    def _commit(self, kv, dest_page, dest_off):
        """Scatter the prefill's K/V ``(2, L, B, S, H, D)`` into the pools
        at ``(page, offset)``, quantizing for an int8 or fp8 cache."""
        cache = self.cache
        pools = cache.pools
        idx = (slice(None), dest_page, dest_off)
        if cache.kv_dtype == "float32":
            pools[0][idx] = kv[0]
            pools[1][idx] = kv[1]
            return
        if cache.kv_dtype == "int8":
            kq, ksc, kmd = kv_quantize_rows(kv[0])
            vq, vsc, vmd = kv_quantize_rows(kv[1])
            rows = (ksc, kmd, vsc, vmd)
        else:
            kq, ksc = kv_quantize_rows_fp8(kv[0])
            vq, vsc = kv_quantize_rows_fp8(kv[1])
            rows = (ksc, vsc)
        pool_bytes(pools[0])[idx] = pool_bytes(kq)
        pool_bytes(pools[1])[idx] = pool_bytes(vq)
        for pool, row in zip(pools[2:], rows):
            pool[idx] = row

    def _quant(self):
        return list(self.cache.pools[2:]) if self.cache.quantized else None

    def step(self, tokens, positions, tables, keys, steps, temps):
        """One decode step for a batch padded to a batch bucket (padded
        rows: token 0, position 0, all-trash table).  Returns the sampled
        next token of each row (host int32); one device-to-host copy."""
        b = tokens.shape[0]
        self._note("step", b)
        cache = self.cache
        tok, pos, tab = self._ints(tokens, positions, tables)
        with _tel.span("decode.step", model=self.name, batch=b):
            with torch.no_grad():
                out = self._block.step_math(
                    self._params, tok, pos, tab, cache.k_pages,
                    cache.v_pages, cache.page_size, quant=self._quant())
                nxt = sample(out[0], keys, steps, temps)
            return nxt.cpu().numpy()

    def verify(self, tokens, positions, n_draft, tables, keys, steps,
               temps):
        """One speculative verify for a batch padded to a batch bucket:
        ``tokens (B, K+1)`` is ``[cur, d_1 .. d_K]`` per row (rows not
        speculating ride with ``n_draft = 0``).  Returns host arrays
        ``(target (B, K+1), n_acc (B,))``: the target model's sample at
        every offset, on the fold ``step + j`` the plain step ``j`` would
        use, and the count of drafts equal to it before the first that is
        not."""
        b, k1 = tokens.shape
        self._note("verify", (b, k1 - 1))
        cache = self.cache
        tok, pos, nd, tab = self._ints(tokens, positions, n_draft, tables)
        with _tel.span("decode.verify", model=self.name, batch=b,
                       k=k1 - 1):
            with torch.no_grad():
                out = self._block.verify_math(
                    self._params, tok, pos, nd, tab, cache.k_pages,
                    cache.v_pages, cache.page_size, quant=self._quant())
                flat = out[0].reshape(b * k1, -1)
                steps_j = (np.asarray(steps, np.int64)[:, None]
                           + np.arange(k1)[None, :]).reshape(-1)
                target = sample(flat, np.repeat(np.asarray(keys), k1,
                                                axis=0),
                                steps_j, np.repeat(np.asarray(temps), k1)
                                ).reshape(b, k1)
                target = target.cpu().numpy()
        ok = ((np.asarray(tokens)[:, 1:] == target[:, :-1])
              & (np.arange(1, k1)[None, :]
                 <= np.asarray(n_draft)[:, None]))
        n_acc = np.cumprod(ok.astype("int32"), axis=1).sum(axis=1)
        return target, n_acc.astype("int32")

    def sample_first(self, logits_row, key, temp):
        """A prefix-hit admission's first token from the cached last-position
        logits: the batch-1 sampler at step 0, row-stable, so it is the
        token a cold prefill would have sampled."""
        self._note("sample_first", 1)
        logits = torch.from_numpy(
            np.asarray(logits_row, "float32")[None]).to(self.device)
        tok = sample(logits, np.asarray(key, "uint32")[None],
                     np.zeros((1,), "int32"), np.asarray([temp], "float32"))
        return int(tok.cpu()[0])
