"""Row-stable contraction ``x . w``: a hand-written Hopper kernel and its
plain version.

The port's own kernel (no TPU counterpart): the JAX decode model's
``rowdot`` (``mxnet_tpu/serving/decode/model.py:41-47``) is a
broadcast-multiply and reduce whose per-row reduction order XLA keeps
independent of the batch.  On the card neither ``torch.matmul`` (cuBLAS
picks kernels and split-K by shape) nor torch's reductions keep a row's
bits when the row count changes, so decode's contractions go through
``csrc/rowdot.cu``, whose order is fixed by the contraction length alone
(see the source).

On a CUDA tensor :func:`rowdot` launches the kernel or raises; it never
falls back.  On a CPU tensor it runs :func:`_reference`, the JAX function's
broadcast-reduce, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against.  ``w`` may be given as a
transposed view (``embed.t()``): the kernel reads it in place.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rowdot"]


def _reference(x, w, bias=None):
    """``(x[..., :, None] * w).sum(-2)`` (+ ``bias``): the JAX function."""
    y = (x[..., :, None] * w).sum(dim=-2)
    return y if bias is None else y + bias


def _orientation(w):
    """0 for a row-major ``(U, V)`` weight, 1 for the transpose of a
    row-major ``(V, U)`` one; raises for any other layout."""
    if w.is_contiguous():
        return 0
    if w.t().is_contiguous():
        return 1
    raise ValueError(f"rowdot takes w row-major or as the transpose of a "
                     f"row-major matrix, got strides {w.stride()}")


def _aligned(t):
    return t.data_ptr() % 16 == 0


def rowdot(x, w, bias=None):
    """``x (..., U) . w (U, V) (+ bias (V,)) -> (..., V)`` in fp32, each
    output row's bits independent of the other rows.
    ``rowdot.launches`` counts kernel launches (CPU calls are not
    counted)."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return _reference(x, w, bias)
    if x.device.type != "cuda" or w.device != x.device or \
            (bias is not None and bias.device != x.device):
        raise ValueError(f"x, w and bias must lie on one CUDA device or all "
                         f"on the CPU, got {x.device}, {w.device}"
                         f"{'' if bias is None else f', {bias.device}'}")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"rowdot takes float32, {name} is {t.dtype}")
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"contract")
    u, v = w.shape
    if bias is not None and (bias.shape != (v,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous of shape ({v},), got "
                         f"{tuple(bias.shape)}")
    trans = _orientation(w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, u)
    if not x2.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x2.shape[0]
    y = torch.empty(lead + (v,), dtype=torch.float32, device=x.device)
    vec = int(u % 4 == 0 and _aligned(x2) and (not trans or _aligned(w)))
    lib = _build.load()
    rc = lib.mxt_rowdot(
        x2.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), n, u, v,
        trans, vec, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rowdot kernel launch failed: "
                           f"{lib.mxt_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    rowdot.launches += 1
    return y


rowdot.launches = 0
