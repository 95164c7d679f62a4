"""BatchNorm batch statistics: a hand-written Hopper kernel and its plain
version.

Counterpart of ``bn_stats_kernel`` in ``benchmark/pallas_bn_stats.py``
(launched at :91): per-channel mean and biased variance of an activation
in one pass with fp32 accumulation.  The optional per-channel shift
``pivot`` is subtracted before squaring (``pivot=None`` is the TPU
kernel's function); ``pivot=FIRST`` shifts by the first element of each
channel, which the kernel reads itself: the pivot of
``mxnet_tpu/ops/nn.py:285-296`` that the training-mode
``ops.nn.batch_norm`` uses.

The kernel takes two layouts, told apart by the strides (:func:`layout`):
a contiguous ``(N, C, ...)`` tensor (the TPU kernel's NCHW, ``"cf"``) and
a tensor whose channel axis is the innermost one, a row-major
``(rows, C)`` matrix (NHWC itself, or NCHW-shaped in
``torch.channels_last`` memory format, ``"cl"``).  Any other layout
raises: the wrapper copies nothing.  Each call is one launch of
``csrc/bn_stats.cu``; its partials and tickets live in scratch kept per
(device, stream), so a call allocates only its output.

On a CUDA tensor :func:`bn_stats` launches the kernel or raises; it never
falls back.  On a CPU tensor it runs ``_reference``, the plain PyTorch
version the tests and ``chip_smoke.py`` hold the kernel against.
:func:`batch_stats` adds the gradient (elementwise plain torch: the JAX
package has no backward kernel for it).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["bn_stats", "batch_stats", "layout", "FIRST"]

# ``pivot=FIRST``: shift each channel by its first element, x[0, c, 0, 0]
FIRST = "first"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# scratch a (device, stream) keeps: partial sums (floats) and tickets,
# 4.25 MB (``_build.stream_scratch``)
_PARTIAL_CAP = 1 << 20
_TICKET_CAP = 1 << 16
_scratch = {}
_lib = None


def _first(x, axis):
    """The first element of each channel along ``axis``, as fp32."""
    return x[tuple(slice(None) if i == axis else 0
                   for i in range(x.dim()))].float()


def _reference(x, pivot=None, axis=1):
    """``xla_stats`` (``benchmark/pallas_bn_stats.py:105-111``), shifted
    by ``pivot``: fp32 ``(mean, var)`` over every axis but ``axis``."""
    axis %= x.dim()
    c = x.shape[axis]
    if isinstance(pivot, str):
        pivot = _first(x, axis)
    if axis == 1:
        d, dims, shape = x.reshape(x.shape[0], c, -1).float(), (0, 2), \
            (1, c, 1)
    else:
        d, dims, shape = x.movedim(axis, -1).reshape(-1, c).float(), (0,), \
            (1, c)
    if pivot is not None:
        d = d - pivot.float().reshape(shape)
    dmean = d.mean(dim=dims)
    var = ((d * d).mean(dim=dims) - dmean * dmean).clamp_min(0.0)
    return (dmean if pivot is None else dmean + pivot.float()), var


def layout(x, axis=1):
    """``"cf"`` when ``x`` is contiguous with the channel on axis 1 (the
    kernel's NCHW layout), ``"cl"`` when the channel axis is the innermost
    in memory over a dense ``(rows, C)`` matrix (channels-last), else
    None.  Decided from sizes and strides, without building a view."""
    nd = x.dim()
    axis %= nd
    if x.is_contiguous():
        if axis == 1:
            return "cf"
        if axis == nd - 1:
            return "cl"
    elif nd == 4 and axis == 1 and \
            x.is_contiguous(memory_format=torch.channels_last):
        return "cl"
    # the general rule: the channel stride 1, the other axes dense over it
    shape, stride = x.shape, x.stride()
    if shape[axis] != 1 and stride[axis] != 1:
        return None
    expect = shape[axis]
    for i in range(nd - 1, -1, -1):
        if i == axis or shape[i] == 1:
            continue
        if stride[i] != expect:
            return None
        expect *= shape[i]
    return "cl"


def _check(x, pivot, axis):
    """The layout (:func:`layout`) of a tensor the kernel takes; raises on
    anything else.  Runs once before each launch."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_stats takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (N, C, ...) tensor, got "
                         f"{tuple(x.shape)}")
    kind = layout(x, axis)
    if kind is None:
        raise ValueError(
            f"bn_stats takes contiguous channel-first data or data whose "
            f"channel axis ({axis}) is innermost in memory, got a "
            f"non-contiguous tensor of shape {tuple(x.shape)} and strides "
            f"{x.stride()}; the kernel does not copy it")
    if pivot is None or (isinstance(pivot, str) and pivot == FIRST):
        return kind
    c = x.shape[axis]
    if isinstance(pivot, str) or pivot.device != x.device or \
            pivot.dtype != torch.float32 or pivot.shape != (c,) or \
            not pivot.is_contiguous():
        raise ValueError(f"pivot must be FIRST or a contiguous float32 "
                         f"({c},) tensor on {x.device}")
    return kind


def _launch(x, pivot, kind, axis, force=None):
    """One launch of the kernel on ``x``'s device and current stream;
    ``force`` = (splits, group, tickets, plan buffer) calls the entry that
    forces the plan and reports it."""
    global _lib
    shape = x.shape
    c = shape[axis]
    if kind == "cf":
        rows = shape[0]
        inner = x.numel() // (rows * c)
    else:
        rows, inner = x.numel() // c, 1
    device = x.get_device()
    if _lib is None:
        _lib = _build.load()
    stream = _build.raw_stream(device)
    scratch = _build.stream_scratch(_scratch, device, stream, _PARTIAL_CAP,
                                    max(_TICKET_CAP, c))
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    first = isinstance(pivot, str)
    args = (x.data_ptr(),
            None if pivot is None or first else pivot.data_ptr(), first,
            scratch[2], _PARTIAL_CAP, scratch[3], scratch[4], out.data_ptr(),
            rows, c, inner, _DTYPES[x.dtype], device, stream)
    rc = _lib.mxt_bn_stats(*args) if force is None else \
        _lib.mxt_bn_stats_plan(*args, *force)
    if rc != 0:
        raise RuntimeError(
            f"bn_stats kernel launch failed at {tuple(shape)}: "
            f"{_lib.mxt_error_string(rc).decode()} (cudaError {rc})")
    return out[0], out[1]


def bn_stats(x, pivot=None, axis=1):
    """Per-channel ``(mean, var)`` of ``x`` over every axis but ``axis``,
    both fp32 ``(C,)``; ``var`` is biased.  ``pivot`` (fp32 ``(C,)``, or
    :data:`FIRST`) is the shift subtracted before squaring.  No gradient:
    see :func:`batch_stats`.  ``bn_stats.launches`` counts kernel launches
    and ``bn_stats.launches_cl`` those on channels-last data among them
    (plain-version calls are not counted); ``bn_stats.copies`` counts the
    inputs ``ops.nn.batch_norm`` had to copy before a launch."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"bn_stats runs on the CPU or CUDA, got "
                             f"{x.device}")
        return _reference(x, pivot, axis)
    axis %= x.dim()
    kind = _check(x, pivot, axis)
    mean, var = _launch(x, pivot, kind, axis)
    bn_stats.launches += 1
    bn_stats.launches_cl += kind == "cl"
    return mean, var


bn_stats.launches = 0
bn_stats.launches_cl = 0
bn_stats.copies = 0


def plan(x, pivot=None, axis=1, splits=0, group=0, tickets=False):
    """For tests and logs: launch the kernel as :func:`bn_stats` does (not
    counted) and return ``(mean, var, plan)``, ``plan`` what the kernel's
    host side chose: ``{"wide", "vec", "group", "splits", "groups",
    "blocks_per_sm", "cluster"}``.  ``splits`` and ``group`` > 0 force S
    and G, and ``tickets`` folds 2-8 slices through the tickets instead of
    a cluster, so that tests reach every fold route."""
    axis %= x.dim()
    kind = _check(x, pivot, axis)
    buf = (ctypes.c_int * 7)()
    mean, var = _launch(x, pivot, kind, axis,
                        (splits, group, int(tickets), ctypes.addressof(buf)))
    keys = ("wide", "vec", "group", "splits", "groups", "blocks_per_sm",
            "cluster")
    return mean, var, dict(zip(keys, buf))


class _BatchStats(torch.autograd.Function):
    """``(mean, var)`` with the gradient of the JAX formulation: the pivot
    is a constant (``stop_gradient``), so
    ``dx = g_mean / cnt + g_var * 2 (x - mean) / cnt``."""

    @staticmethod
    def forward(ctx, x, pivot, axis):
        mean, var = bn_stats(x, pivot, axis)
        ctx.save_for_backward(x, mean)
        ctx.axis = axis % x.dim()
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        c = x.shape[ctx.axis]
        cnt = x.numel() // c
        shape = [1] * x.dim()
        shape[ctx.axis] = c
        # centred before scaling: x * a - a * mean would cancel when
        # |mean| >> std
        dx = (x.float() - mean.reshape(shape)) * (g_var * (2.0 / cnt)).reshape(
            shape) + (g_mean / cnt).reshape(shape)
        return dx.to(x.dtype), None, None


def batch_stats(x, pivot=None, axis=1):
    """:func:`bn_stats` with a gradient with respect to ``x``."""
    return _BatchStats.apply(x, pivot, axis)
