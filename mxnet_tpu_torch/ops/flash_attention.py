"""Flash attention: a hand-written Hopper forward kernel, its plain version,
and the gradient.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``.  ``flash_attention``
keeps the JAX function's signature and ``(B, H, T, D)`` layout, minus the
TPU's block sizes and interpreter switch.  On a CUDA tensor it launches the
CUDA kernel in ``csrc/flash_attention.cu`` or raises; it never falls back.
On a CPU tensor it runs ``_reference``, the plain PyTorch version the tests
and ``chip_smoke.py`` hold the kernel against.

The function is differentiable on both devices, as the JAX function's
``custom_vjp`` (:129) is.  The JAX package has no backward kernel: its
``_fa_bwd`` (:155-163) is XLA's vjp of the dense ``_reference``.  Here the
backward is :func:`_attention_backward`, the same dense recompute written
out in torch matmuls in fp32; it does not call ``_reference``, so on the
card the forward's kernel launch stays the only attention forward.

Unlike the JAX function, the kernel masks a ragged T itself in both modes,
so no shape bypasses it, and it takes D <= 128 as it is, without padding
to 128 lanes.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _reference(q, k, v, causal, scale):
    """Dense attention in fp32 (``pallas_kernels.py:117-126``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _check(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"q {tuple(q.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, D), got {tuple(q.shape)}")
    b, h, t, d = q.shape
    if not (1 <= d <= 128):
        raise ValueError(f"head width D={d} outside 1..128")
    if b * h < 1 or t < 1:
        raise ValueError(f"empty input {tuple(q.shape)}")


def _attention_backward(q, k, v, grad_out, causal, scale):
    """``(dQ, dK, dV)`` of ``softmax(Q K^T * scale) V`` for ``grad_out``,
    in fp32 and cast to the inputs' dtype: the vjp of ``_reference`` that
    ``_fa_bwd`` takes, with P recomputed from Q and K (so a bf16 output's
    rounding does not enter the gradient) and the softmax's vjp
    ``dS = P * (dP - rowsum(P * dP))``."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, grad_out))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The kernel on CUDA tensors, ``_reference`` on CPU tensors, with the
    backward of :func:`_attention_backward`.  Without grad mode, or with no
    input that requires grad, it builds no graph node."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        kinds = {x.device.type for x in (q, k, v)}
        if kinds == {"cpu"}:
            return _reference(q, k, v, causal, scale)
        if kinds != {"cuda"}:
            raise ValueError(f"q, k, v must all lie on the CPU or all on "
                             f"CUDA, got {q.device}, {k.device}, {v.device}")
        _check(q, k, v)
        out = _launch(_build.load(), q, k, v, causal, scale)
        flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        flash_attention.backward_calls += 1
        return (*_attention_backward(q, k, v, grad_out, ctx.causal,
                                     ctx.scale), None, None)


def flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise attention, ``(B, H, T, D) -> (B, H, T, D)``.

    ``scale=None`` means ``1/sqrt(D)``.  The output has the input's dtype;
    the kernel accumulates in fp32.  With grad mode on and an input that
    requires grad, the output carries the gradient of
    :func:`_attention_backward`.  ``flash_attention.launches`` counts
    kernel launches (plain-version calls are not counted);
    ``flash_attention.backward_calls`` counts backward passes, on either
    device."""
    scale_v = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, bool(causal), scale_v)


def _launch(lib, q, k, v, causal, scale):
    """One launch of ``lib``'s kernel on checked CUDA inputs; raises if the
    launch fails."""
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    rc = lib.mxt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, t, d, scale, int(bool(causal)), _DTYPES[q.dtype],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: "
            f"{lib.mxt_error_string(rc).decode()} (cudaError {rc})")
    return out


flash_attention.launches = 0
flash_attention.backward_calls = 0
