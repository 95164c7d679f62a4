"""BatchNorm batch statistics: a hand-written Hopper kernel and its plain
version.

Counterpart of ``bn_stats_kernel`` in ``benchmark/pallas_bn_stats.py``
(launched at :91): per-channel mean and biased variance of an NCHW
activation in one pass with fp32 accumulation.  The optional per-channel
shift ``pivot`` is subtracted before squaring (``pivot=None`` is the TPU
kernel's function); the training-mode ``ops.nn.batch_norm`` passes the
pivot of ``mxnet_tpu/ops/nn.py:285-296``.

On a CUDA tensor :func:`bn_stats` launches ``csrc/bn_stats.cu`` or raises;
it never falls back.  On a CPU tensor it runs ``_reference``, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel against.
:func:`batch_stats` adds the gradient (elementwise plain torch: the JAX
package has no backward kernel for it).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["bn_stats", "batch_stats"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# resident 256-thread blocks an SM holds; stage 1 aims at one full wave
_BLOCKS_PER_SM = 8
# fewest elements a stage-1 block reduces, so that small channels do not
# split into blocks that launch for a handful of loads
_MIN_BLOCK_ELEMS = 2048


def _reference(x, pivot=None):
    """``xla_stats`` (``benchmark/pallas_bn_stats.py:105-111``), shifted
    by ``pivot``: fp32 ``(mean, var)`` over every axis but 1."""
    n, c = x.shape[:2]
    d = x.reshape(n, c, -1).float()
    if pivot is not None:
        d = d - pivot.float().reshape(1, c, 1)
    dmean = d.mean(dim=(0, 2))
    var = ((d * d).mean(dim=(0, 2)) - dmean * dmean).clamp_min(0.0)
    return (dmean if pivot is None else dmean + pivot.float()), var


def _check(x, pivot):
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_stats takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (N, C, ...) tensor, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        kind = "channels_last" if x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last) else "non-contiguous"
        raise ValueError(f"bn_stats takes contiguous NCHW data, got a "
                         f"{kind} tensor; the kernel does not copy it")
    if pivot is not None and (pivot.device != x.device
                              or pivot.dtype != torch.float32
                              or pivot.shape != x.shape[1:2]
                              or not pivot.is_contiguous()):
        raise ValueError(f"pivot must be a contiguous float32 ({x.shape[1]},)"
                         f" tensor on {x.device}")


def _vector_width(x, hw):
    """Elements per load: the widest of 16/8/4/2/1 bytes that divides H*W
    and the base address."""
    es = x.element_size()
    vec = 16 // es
    while vec > 1 and (hw % vec or x.data_ptr() % (vec * es)):
        vec //= 2
    return vec


def bn_stats(x, pivot=None):
    """Per-channel ``(mean, var)`` of ``x`` (``(N, C, ...)``) over every
    axis but 1, both fp32 ``(C,)``; ``var`` is biased.  ``pivot`` (fp32
    ``(C,)``) is the shift subtracted before squaring.  No gradient: see
    :func:`batch_stats`.  ``bn_stats.launches`` counts kernel launches
    (plain-version calls are not counted)."""
    if x.device.type == "cpu":
        return _reference(x, pivot)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats runs on the CPU or CUDA, got {x.device}")
    _check(x, pivot)
    n, c = x.shape[:2]
    hw = x.numel() // (n * c)
    vec = _vector_width(x, hw)
    if n * (hw // vec) > 2**31 - 1:
        raise ValueError(f"{tuple(x.shape)}: over 2^31 loads per channel")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(-(-_BLOCKS_PER_SM * sms // c),
                        -(-n * hw // _MIN_BLOCK_ELEMS), 65535))
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty(2 * c * splits, **f32)
    mean, var = torch.empty(c, **f32), torch.empty(c, **f32)
    lib = _build.load()
    rc = lib.mxt_bn_stats(
        x.data_ptr(), None if pivot is None else pivot.data_ptr(),
        partial.data_ptr(), mean.data_ptr(), var.data_ptr(), n, c, hw,
        splits, vec, _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"bn_stats kernel launch failed: "
            f"{lib.mxt_error_string(rc).decode()} (cudaError {rc})")
    bn_stats.launches += 1
    return mean, var


bn_stats.launches = 0


class _BatchStats(torch.autograd.Function):
    """``(mean, var)`` with the gradient of the JAX formulation: the pivot
    is a constant (``stop_gradient``), so
    ``dx = g_mean / cnt + g_var * 2 (x - mean) / cnt``."""

    @staticmethod
    def forward(ctx, x, pivot):
        mean, var = bn_stats(x, pivot)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        n, c = x.shape[:2]
        cnt = x.numel() // c
        shape = (1, c) + (1,) * (x.dim() - 2)
        # centred before scaling: x * a - a * mean would cancel when
        # |mean| >> std
        dx = (x.float() - mean.reshape(shape)) * (g_var * (2.0 / cnt)).reshape(
            shape) + (g_mean / cnt).reshape(shape)
        return dx.to(x.dtype), None


def batch_stats(x, pivot=None):
    """:func:`bn_stats` with a gradient with respect to ``x``."""
    return _BatchStats.apply(x, pivot)
