"""BatchNorm batch statistics: a hand-written Hopper kernel and its plain
version.

Counterpart of ``bn_stats_kernel`` in ``benchmark/pallas_bn_stats.py``
(launched at :91): per-channel mean and biased variance of an activation
in one pass with fp32 accumulation.  The optional per-channel shift
``pivot`` is subtracted before squaring (``pivot=None`` is the TPU
kernel's function); the training-mode ``ops.nn.batch_norm`` passes the
pivot of ``mxnet_tpu/ops/nn.py:285-296``.

The kernel has two entries, picked from the strides: ``mxt_bn_stats``
reads a contiguous ``(N, C, ...)`` tensor (the TPU kernel's NCHW), and
``mxt_bn_stats_cl`` a tensor whose channel axis is the innermost one,
a row-major ``(rows, C)`` matrix (NHWC itself, or NCHW-shaped in
``torch.channels_last`` memory format).  Any other layout raises: the
wrapper copies nothing.

On a CUDA tensor :func:`bn_stats` launches ``csrc/bn_stats.cu`` or raises;
it never falls back.  On a CPU tensor it runs ``_reference``, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel against.
:func:`batch_stats` adds the gradient (elementwise plain torch: the JAX
package has no backward kernel for it).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["bn_stats", "batch_stats", "layout"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# resident 256-thread blocks an SM holds; stage 1 aims at one full wave
_BLOCKS_PER_SM = 8
_THREADS = 256
# fewest elements a stage-1 block reduces, so that small channels do not
# split into blocks that launch for a handful of loads
_MIN_BLOCK_ELEMS = 2048


def _reference(x, pivot=None, axis=1):
    """``xla_stats`` (``benchmark/pallas_bn_stats.py:105-111``), shifted
    by ``pivot``: fp32 ``(mean, var)`` over every axis but ``axis``."""
    c = x.shape[axis]
    if axis % x.dim() == 1:
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
    kernel's NCHW entry), ``"cl"`` when the channel axis is the innermost
    in memory over a dense ``(rows, C)`` matrix (its channels-last entry),
    else None."""
    axis %= x.dim()
    if axis == 1 and x.is_contiguous():
        return "cf"
    if x.movedim(axis, -1).is_contiguous():
        return "cl"
    return None


def _check(x, pivot, axis):
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
    c = x.shape[axis]
    if pivot is not None and (pivot.device != x.device
                              or pivot.dtype != torch.float32
                              or pivot.shape != (c,)
                              or not pivot.is_contiguous()):
        raise ValueError(f"pivot must be a contiguous float32 ({c},) "
                         f"tensor on {x.device}")
    return kind


def _vector_width(x, run):
    """Elements per load: the widest of 16/8/4/2/1 bytes that divides the
    contiguous run (H*W, or C channels-last) and the base address."""
    es = x.element_size()
    vec = 16 // es
    while vec > 1 and (run % vec or x.data_ptr() % (vec * es)):
        vec //= 2
    return vec


def _splits(sms, blocks, elems):
    """Row slices of stage 1: a full wave of ``blocks`` column blocks, at
    least ``_MIN_BLOCK_ELEMS`` of the ``elems`` a column block reduces."""
    return max(1, min(-(-_BLOCKS_PER_SM * sms // blocks),
                      -(-elems // _MIN_BLOCK_ELEMS), 65535))


def bn_stats(x, pivot=None, axis=1):
    """Per-channel ``(mean, var)`` of ``x`` over every axis but ``axis``,
    both fp32 ``(C,)``; ``var`` is biased.  ``pivot`` (fp32 ``(C,)``) is
    the shift subtracted before squaring.  No gradient: see
    :func:`batch_stats`.  ``bn_stats.launches`` counts kernel launches and
    ``bn_stats.launches_cl`` those of the channels-last entry among them
    (plain-version calls are not counted); ``bn_stats.copies`` counts the
    inputs ``ops.nn.batch_norm`` had to copy before a launch."""
    if x.device.type == "cpu":
        return _reference(x, pivot, axis)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats runs on the CPU or CUDA, got {x.device}")
    axis %= x.dim()
    kind = _check(x, pivot, axis)
    c = x.shape[axis]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    f32 = dict(dtype=torch.float32, device=x.device)
    mean, var = torch.empty(c, **f32), torch.empty(c, **f32)
    pivot_ptr = None if pivot is None else pivot.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load()
    if kind == "cf":
        n = x.shape[0]
        hw = x.numel() // (n * c)
        vec = _vector_width(x, hw)
        if n * (hw // vec) > 2**31 - 1:
            raise ValueError(f"{tuple(x.shape)}: over 2^31 loads per "
                             f"channel")
        splits = _splits(sms, c, n * hw)
        partial = torch.empty(2 * c * splits, **f32)
        rc = lib.mxt_bn_stats(
            x.data_ptr(), pivot_ptr, partial.data_ptr(), mean.data_ptr(),
            var.data_ptr(), n, c, hw, splits, vec, _DTYPES[x.dtype],
            x.device.index, stream)
    else:
        rows = x.numel() // c
        vec = _vector_width(x, c)
        if rows > 2**31 - 1:
            raise ValueError(f"{tuple(x.shape)}: over 2^31 rows")
        # a block spans `width` vectors of a row (a power of two, at most
        # one per thread); its threads take the rows in turn
        width = 1
        while width < min(-(-c // vec), _THREADS):
            width *= 2
        col_blocks = -(-c // (width * vec))
        splits = _splits(sms, col_blocks, rows * min(c, width * vec))
        partial = torch.empty(2 * c * splits, **f32)
        rc = lib.mxt_bn_stats_cl(
            x.data_ptr(), pivot_ptr, partial.data_ptr(), mean.data_ptr(),
            var.data_ptr(), rows, c, splits, vec, width, _DTYPES[x.dtype],
            x.device.index, stream)
    if rc != 0:
        raise RuntimeError(
            f"bn_stats kernel launch failed: "
            f"{lib.mxt_error_string(rc).decode()} (cudaError {rc})")
    bn_stats.launches += 1
    bn_stats.launches_cl += kind == "cl"
    return mean, var


bn_stats.launches = 0
bn_stats.launches_cl = 0
bn_stats.copies = 0


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
