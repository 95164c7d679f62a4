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

One launch a call, in one of two regimes the C side chooses: up to 40
rows (decode, verify) a split of each column tile's chunks of ``U``
across blocks, folded in chunk order inside the launch; more rows
(prefill) a register-tiled SGEMM.  The split regime's workspace and
tickets are the wrapper's: allocated per (device, stream) at its first
call and kept (the kernel leaves the tickets at zero).
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


# scratch a (device, stream) keeps: chunk partials of split column tiles
# (floats) and their tickets, 8.25 MB (``_build.stream_scratch``)
_PARTIAL_CAP = 1 << 21
_TICKET_CAP = 1 << 16
_scratch = {}
_lib = None


def _check(x, w, bias):
    """(x as (N, U), orientation) after checking devices, dtypes, shapes
    and layouts; raises on anything the kernel does not take."""
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
    v = w.shape[1]
    if bias is not None and (bias.shape != (v,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous of shape ({v},), got "
                         f"{tuple(bias.shape)}")
    trans = _orientation(w)
    x2 = x.reshape(-1, w.shape[0])
    if not x2.is_contiguous():
        raise ValueError("x must be contiguous")
    return x2, trans


def _launch(x, w, bias=None, plan=0, used=None):
    """One launch on ``x``'s device and current stream.  ``plan`` 0 lets
    the C side choose; ``k > 0`` asks for the split regime with ``k``
    splits, -1 for the tiled regime (the GPU tests reach every route so).
    ``used``, an int32 CPU tensor of 2, receives (regime: 0 split, 1
    tiled; splits)."""
    global _lib
    x2, trans = _check(x, w, bias)
    n, (u, v) = x2.shape[0], w.shape
    y = torch.empty(x.shape[:-1] + (v,), dtype=torch.float32,
                    device=x.device)
    device = x.get_device()
    if _lib is None:
        _lib = _build.load()
    stream = _build.raw_stream(device)
    scratch = _build.stream_scratch(_scratch, device, stream, _PARTIAL_CAP,
                                    _TICKET_CAP)
    rc = _lib.mxt_rowdot(
        x2.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), n, u, v,
        trans, scratch[2], _PARTIAL_CAP, scratch[3], _TICKET_CAP, plan,
        None if used is None else used.data_ptr(), device, stream)
    if rc != 0:
        raise RuntimeError(f"rowdot kernel launch failed: "
                           f"{_lib.mxt_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    return y


def rowdot(x, w, bias=None):
    """``x (..., U) . w (U, V) (+ bias (V,)) -> (..., V)`` in fp32, each
    output row's bits independent of the other rows.
    ``rowdot.launches`` counts kernel launches (CPU calls are not
    counted)."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return _reference(x, w, bias)
    y = _launch(x, w, bias)
    rowdot.launches += 1
    return y


rowdot.launches = 0
