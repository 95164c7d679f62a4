"""Causal-LM decode model: one math implementation for prefill AND step
(counterpart of ``mxnet_tpu/serving/decode/model.py``).

The decode runtime has two surfaces that must agree numerically: the
prefill (the whole padded prompt, emitting every layer's K/V for the
cache) and the per-token step (reading K/V back through the paged cache).
Both are built here from the same layer function, :meth:`CausalLM._layer`,
whose only varying piece is ``attend``.

**The row-stable contract.**  Continuous batching promises each request
tokens bitwise equal to a solo run of it.  Every operation here is
therefore row-stable on the card: the contractions go through
:func:`~mxnet_tpu_torch.ops.rowdot.rowdot` (``csrc/rowdot.cu``, a fixed
summation order per output), the step's and the verify's attention through
:func:`~mxnet_tpu_torch.ops.paged_attention.paged_attention`
(``csrc/paged_attention.cu``, 64-key chunks folded in chunk order), the
prefill's through the flash kernel (``csrc/flash_attention.cu``, causal: a
valid row sees no padded key), LayerNorm through ``F.layer_norm`` (one
block per row) and GELU elementwise; the quantizers reduce over a token
row's own ``(H, D)`` only.  On the CPU the same functions run their plain versions,
which the tests hold against the JAX package.

The JAX functions are pure and return updated page arrays; here
:meth:`CausalLM.step_math` and :meth:`CausalLM.verify_math` update the
pools in place (the donation of the JAX programs) and return them, so the
signatures stay the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...gluon.block import HybridBlock
from ...ndarray.ndarray import NDArray
from ...ops.flash_attention import flash_attention
from ...ops.paged_attention import paged_attention, pool_bytes
from ...ops.rowdot import rowdot
from .sampling import sample

__all__ = ["CausalLM", "get_decode_model", "rowdot", "kv_quantize_rows",
           "kv_dequantize", "kv_quantize_rows_fp8", "kv_dequantize_fp8"]

_FP8 = torch.float8_e4m3fn


def _ln(x, g, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def kv_quantize_rows(x):
    """Affine int8 quantization of K/V token rows ``x (..., H, D)``: one
    ``(scale, mid)`` pair per leading index, reduced over the last two axes
    only, so a row's codes depend on that row alone.  Returns ``(q int8,
    scale, mid)``; an all-zero row maps to ``scale = mid = 0``.  The codes
    equal the JAX function's bit for bit: the same divisions, and
    ``torch.round`` rounds half to even as ``jnp.round`` does."""
    lo = x.amin(dim=(-2, -1))
    hi = x.amax(dim=(-2, -1))
    scale = (hi - lo) / 254.0
    mid = (hi + lo) * 0.5
    div = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round((x - mid[..., None, None]) / div[..., None, None])
    return q.clamp(-127.0, 127.0).to(torch.int8), scale, mid


def kv_dequantize(q, scale, mid):
    """Inverse of :func:`kv_quantize_rows`: ``q * scale + mid`` broadcast
    over the trailing ``(H, D)`` axes."""
    return q.float() * scale[..., None, None] + mid[..., None, None]


def kv_quantize_rows_fp8(x):
    """fp8 (e4m3) quantization of K/V token rows ``x (..., H, D)`` with a
    per-row absmax scale.  Returns ``(q float8_e4m3fn, scale)``."""
    amax = x.abs().amax(dim=(-2, -1))
    scale = amax / 448.0                 # e4m3fn finite max
    div = torch.where(scale > 0, scale, torch.ones_like(scale))
    return (x / div[..., None, None]).to(_FP8), scale


def kv_dequantize_fp8(q, scale):
    """Inverse of :func:`kv_quantize_rows_fp8`: ``q * scale``."""
    return q.float() * scale[..., None, None]


def _kv_scatter(state, i, wp, woff, k, v):
    """Write one layer's new K/V rows into the pools at ``(page, offset)``
    in place, quantizing by sidecar arity (``None`` fp32, 2 fp8, 4 int8).
    ``wp``/``woff`` are ``(B,)`` (step) or ``(B, K+1)`` (verify)."""
    qs = state["q"]
    idx = (wp, woff)
    if qs is None:
        state["k"][i].index_put_(idx, k)
        state["v"][i].index_put_(idx, v)
        return
    if len(qs) == 2:
        kq, ksc = kv_quantize_rows_fp8(k)
        vq, vsc = kv_quantize_rows_fp8(v)
        rows = (ksc, vsc)
    else:
        kq, ksc, kmd = kv_quantize_rows(k)
        vq, vsc, vmd = kv_quantize_rows(v)
        rows = (ksc, kmd, vsc, vmd)
    pool_bytes(state["k"][i]).index_put_(idx, pool_bytes(kq))
    pool_bytes(state["v"][i]).index_put_(idx, pool_bytes(vq))
    for j, row in enumerate(rows):
        qs[j][i].index_put_(idx, row)


def _layer_quant(state, i):
    return None if state["q"] is None else [t[i] for t in state["q"]]


class CausalLM(HybridBlock):
    """Decoder-only transformer (pre-LN, learned positions, tied embedding,
    tanh GELU: GPT-2's architecture).

    ``forward(tokens, lengths)``: tokens ``(B, S)`` int padded to the seq
    bucket, lengths ``(B,)``; returns ``(last_logits (B, vocab), kv (2,
    layers, B, S, heads, head_dim))``.  Parameter names and
    ``_param_order`` are the JAX block's, so its ``save_parameters`` file
    loads here."""

    def __init__(self, vocab_size=512, units=128, num_layers=2, num_heads=4,
                 max_length=128, hidden_size=None, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError(f"units={units} not divisible by "
                             f"num_heads={num_heads}")
        self.vocab_size = int(vocab_size)
        self.units = int(units)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = self.units // self.num_heads
        self.max_length = int(max_length)
        self.hidden_size = int(hidden_size or 4 * units)
        u, hid = self.units, self.hidden_size
        get = self.params.get
        self.embed = get("embed", shape=(self.vocab_size, u), init="normal")
        self.pos_embed = get("pos_embed", shape=(self.max_length, u),
                             init="normal")
        self.lnf_g = get("lnf_g", shape=(u,), init="ones")
        self.lnf_b = get("lnf_b", shape=(u,), init="zeros")
        shapes = (("ln1_g", (u,), "ones"), ("ln1_b", (u,), "zeros"),
                  ("wqkv", (u, 3 * u), "normal"),
                  ("bqkv", (3 * u,), "zeros"),
                  ("wo", (u, u), "normal"), ("bo", (u,), "zeros"),
                  ("ln2_g", (u,), "ones"), ("ln2_b", (u,), "zeros"),
                  ("w1", (u, hid), "normal"), ("b1", (hid,), "zeros"),
                  ("w2", (hid, u), "normal"), ("b2", (u,), "zeros"))
        for i in range(self.num_layers):
            for name, shape, init in shapes:
                setattr(self, f"l{i}_{name}",
                        get(f"l{i}_{name}", shape=shape, init=init))
        self._param_order = sorted(self._reg_params)
        self._scale = 1.0 / math.sqrt(self.head_dim)

    # ------------------------------------------------------------ pure math
    def _params_dict(self, leaves):
        return dict(zip(self._param_order, leaves))

    def param_leaves(self):
        """The parameters' tensors in ``_param_order``."""
        return [self._reg_params[n].tensor().detach()
                for n in self._param_order]

    @property
    def device(self):
        return self._reg_params["embed"].tensor().device

    def _layer(self, p, i, h, attend):
        """One pre-LN transformer layer; ``attend(q, k, v)`` supplies the
        attention context, the only piece prefill and step do not share."""
        a = _ln(h, p[f"l{i}_ln1_g"], p[f"l{i}_ln1_b"])
        qkv = rowdot(a, p[f"l{i}_wqkv"], p[f"l{i}_bqkv"])
        q, k, v = qkv.split(self.units, dim=-1)
        ctx = attend(q * self._scale, k, v)
        h = h + rowdot(ctx, p[f"l{i}_wo"], p[f"l{i}_bo"])
        m = _ln(h, p[f"l{i}_ln2_g"], p[f"l{i}_ln2_b"])
        return h + rowdot(_gelu(rowdot(m, p[f"l{i}_w1"], p[f"l{i}_b1"])),
                          p[f"l{i}_w2"], p[f"l{i}_b2"])

    def prefill_math(self, p, tokens, lengths):
        """Prefill: ``(last_logits, kv)``.  Attention is the flash kernel,
        causal, on ``(B, H, S, D)``; the logits are taken at each row's last
        valid position only."""
        B, S = tokens.shape
        H, D = self.num_heads, self.head_dim
        tokens = tokens.long()
        h = p["embed"][tokens] + p["pos_embed"][:S][None]
        ks, vs = [], []

        def heads(t):
            return t.reshape(B, S, H, D).transpose(1, 2).contiguous()

        def attend(q, k, v):
            ks.append(k.reshape(B, S, H, D))
            vs.append(v.reshape(B, S, H, D))
            o = flash_attention(heads(q), heads(k), heads(v), causal=True,
                                scale=1.0)
            return o.transpose(1, 2).reshape(B, S, -1)

        for i in range(self.num_layers):
            h = self._layer(p, i, h, attend)
        last = h[torch.arange(B, device=h.device), lengths.long() - 1]
        hf = _ln(last, p["lnf_g"], p["lnf_b"])
        logits = rowdot(hf, p["embed"].t())
        return logits, torch.stack([torch.stack(ks), torch.stack(vs)])

    def step_math(self, p, tokens, positions, tables, k_pages, v_pages,
                  page_size, quant=None):
        """Fused decode step for one token per row: scatter each row's new
        K/V into its page (padded rows write trash page 0), attend over the
        row's paged context, and return ``(logits, k_pages, v_pages[,
        sidecars...])``, the pools updated in place."""
        B = tokens.shape[0]
        H, D = self.num_heads, self.head_dim
        positions = positions.long()
        h = p["embed"][tokens.long()] + p["pos_embed"][positions]
        wp = tables.long().gather(1, (positions // page_size)[:, None])[:, 0]
        woff = positions % page_size
        tables32 = tables.to(torch.int32).contiguous()
        pos32 = positions.to(torch.int32)
        state = {"k": k_pages, "v": v_pages, "i": 0,
                 "q": list(quant) if quant is not None else None}

        def attend(q, k, v):
            i = state["i"]
            _kv_scatter(state, i, wp, woff,
                        k.reshape(B, H, D), v.reshape(B, H, D))
            o = paged_attention(q.reshape(B, 1, H, D).contiguous(),
                                k_pages[i], v_pages[i], tables32, pos32,
                                _layer_quant(state, i))
            state["i"] = i + 1
            return o.reshape(B, -1)

        for i in range(self.num_layers):
            h = self._layer(p, i, h, attend)
        hf = _ln(h, p["lnf_g"], p["lnf_b"])
        logits = rowdot(hf, p["embed"].t())
        out = (logits, k_pages, v_pages)
        return out if quant is None else out + tuple(quant)

    def verify_math(self, p, tokens, positions, n_draft, tables, k_pages,
                    v_pages, page_size, quant=None):
        """Fused speculative verify: ``tokens (B, K+1)`` is ``[cur, d_1 ..
        d_K]`` at positions ``positions + (0 .. K)``.  Candidate K/V past
        ``n_draft`` or past the page table goes to trash page 0; query ``j``
        sees positions ``<= positions + j``, so its logits are bitwise the
        plain step's after ``d_1 .. d_j``.  Returns ``(logits (B, K+1, V),
        k_pages, v_pages[, sidecars...])``."""
        B, K1 = tokens.shape
        H, D = self.num_heads, self.head_dim
        n_tab = tables.shape[1]
        dev = tokens.device
        positions = positions.long()
        offs = torch.arange(K1, device=dev)[None, :]
        pos = positions[:, None] + offs                       # (B, K+1)
        h = (p["embed"][tokens.long()]
             + p["pos_embed"][pos.clamp(max=self.max_length - 1)])
        page_idx = pos // page_size
        owned = tables.long().gather(1, page_idx.clamp(max=n_tab - 1))
        valid = (offs <= n_draft.long()[:, None]) & (page_idx < n_tab)
        wp = torch.where(valid, owned, torch.zeros_like(owned))
        woff = pos % page_size
        tables32 = tables.to(torch.int32).contiguous()
        pos32 = positions.to(torch.int32)
        state = {"k": k_pages, "v": v_pages, "i": 0,
                 "q": list(quant) if quant is not None else None}

        def attend(q, k, v):
            i = state["i"]
            _kv_scatter(state, i, wp, woff,
                        k.reshape(B, K1, H, D), v.reshape(B, K1, H, D))
            o = paged_attention(q.reshape(B, K1, H, D).contiguous(),
                                k_pages[i], v_pages[i], tables32, pos32,
                                _layer_quant(state, i))
            state["i"] = i + 1
            return o.reshape(B, K1, -1)

        for i in range(self.num_layers):
            h = self._layer(p, i, h, attend)
        hf = _ln(h, p["lnf_g"], p["lnf_b"])
        logits = rowdot(hf, p["embed"].t())
        out = (logits, k_pages, v_pages)
        return out if quant is None else out + tuple(quant)

    def sample_math(self, logits, keys, steps, temps):
        """Per-row next token: greedy at ``temp == 0``, Gumbel-max
        temperature sampling otherwise, on JAX's per-request stream
        (``fold_in(key, step)``, then ``uniform``; see :mod:`.sampling`).
        ``keys (B, 2)``, ``steps (B,)`` and ``temps (B,)`` are host
        arrays."""
        return sample(logits, keys, steps, temps)

    # ------------------------------------------------------- gluon frontend
    def hybrid_forward(self, F, tokens, lengths, **params):
        if not isinstance(tokens, NDArray):
            raise NotImplementedError(
                "CausalLM has no symbolic frontend (export is not "
                "supported); the decode runtime runs it eagerly")
        leaves = [params[n]._data for n in self._param_order]
        logits, kv = self.prefill_math(self._params_dict(leaves),
                                       tokens._data, lengths._data)
        return NDArray(logits), NDArray(kv)


_DECODE_CONFIGS = {
    "decode_tiny": dict(units=64, num_layers=2, num_heads=2),
    "decode_small": dict(units=128, num_layers=2, num_heads=4),
    "decode_base": dict(units=256, num_layers=4, num_heads=8),
}


def get_decode_model(model_name="decode_small", vocab_size=512,
                     max_length=128, **kwargs):
    """Named :class:`CausalLM` configurations (the JAX function's)."""
    cfg = dict(_DECODE_CONFIGS[model_name])
    cfg.update(kwargs)
    return CausalLM(vocab_size=vocab_size, max_length=max_length, **cfg)
