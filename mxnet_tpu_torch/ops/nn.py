"""Plain PyTorch counterparts of the JAX package's layer ops.

``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``BatchNorm`` and ``LayerNorm``/``softmax`` come from ``mxnet_tpu/ops/nn.py``
(:33, :88, :119, :179, :267, :369, :434), ``Activation`` from
``mxnet_tpu/ops/elemwise.py`` (:156),
``Flatten`` and ``Embedding`` from ``mxnet_tpu/ops/matrix.py`` (:80, :288).
XLA computed these outside any Pallas kernel, so here they stay torch
operators (cuDNN convolutions, inference normalisation and cuBLAS
products), except BatchNorm's training-mode batch statistics, which run on
the port's counterpart of ``bn_stats_kernel`` (``ops/bn_stats.py``).

Channel-first (NCW/NCHW/NCDHW) and channel-last (NWC/NHWC/NDHWC) layouts
are both taken, as in the JAX package (``_spec``/``_channel_pos`` at
``mxnet_tpu/ops/nn.py:54-85``).  A channel-last convolution or pooling
hands torch a ``permute`` view of the data (and of the weight, stored
``(num_filter, *kernel, C/g)`` as there), which is a tensor in
``torch.channels_last`` memory format: cuDNN reads it as it lies and
returns the same format, so the permuted-back output is contiguous in
the caller's layout and nothing is copied.  ``Deconvolution`` (the
transposed convolution) takes the weight ``(C, num_filter / num_group,
*kernel)``, ``(C, *kernel, num_filter / num_group)`` channel-last, and
runs on torch's ``conv_transpose``.  Pooling takes 1-, 2- and 3-D
windows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import parse_bool, parse_float, parse_int, parse_tuple, \
    torch_dtype
from . import bn_stats as _bs
from .registry import register

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "batch_norm",
           "update_moving_stats", "activation", "flatten", "layer_norm",
           "softmax", "embedding", "ctc_loss"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


_LOW = (torch.bfloat16, torch.float16)


def fully_connected(data, weight, bias=None, flatten=True):
    """``y = x W^T + b`` with weight layout ``(num_hidden, in_dim)``;
    ``flatten`` folds every axis after the first into the input.  In bf16
    and fp16 the bias is added to the rounded product, as the JAX op
    (``mxnet_tpu/ops/nn.py:33-43``) and MXNet's own layer add it; in fp32
    the fused call rounds once, the same to within fp32 rounding."""
    if flatten:
        data = data.reshape(data.shape[0], -1)
    if bias is not None and data.dtype in _LOW:
        return F.linear(data, weight) + bias
    return F.linear(data, weight, bias)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalise over ``axis`` (biased variance, statistics in fp32)."""
    x = data.movedim(axis, -1)
    out = F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(data.dtype)
    return (out * gamma + beta).movedim(-1, axis)


def softmax(data, axis=-1):
    return torch.softmax(data, dim=axis)


def embedding(data, weight):
    """Row gather; ids are clipped into the table as the reference does
    (its gather clamps), and int32 ids become the ``long`` torch needs."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


def _tuple(v, nd, default):
    if v is None or v == ():
        return (default,) * nd
    if isinstance(v, int):
        return (v,) * nd
    v = tuple(int(i) for i in v)
    if len(v) != nd:
        raise ValueError(f"expected {nd} values, got {v}")
    return v


def _channel_axis(layout, ndim):
    """The channel axis of an MXNet layout string (``None``: axis 1)."""
    if layout in (None, "None", ""):
        return 1
    lay = str(layout)
    if len(lay) != ndim or lay[0] != "N" or "C" not in lay:
        raise ValueError(f"bad layout {layout!r} for {ndim}-d data")
    return lay.index("C")


def _to_channel_first(x, ax):
    """A view of ``x`` with its channel axis ``ax`` moved to 1."""
    return x if ax == 1 else x.movedim(ax, 1)


def _channel_first_call(op, data, weight, bias, layout, *args):
    """``op(x, w, bias, *args)`` (a torch convolution) on channel-first
    views of ``data`` and ``weight``, whose channel axis is the second or
    the last; the output in ``data``'s layout.  In bf16 and fp16 the bias
    is added to the rounded output, as :func:`fully_connected` adds it."""
    nd = data.dim() - 2
    ax = _channel_axis(layout, data.dim())
    if ax not in (1, nd + 1):
        raise ValueError(f"layout {layout!r}: the channel axis must be "
                         f"second or last")
    x, w = _to_channel_first(data, ax), _to_channel_first(weight, ax)
    late = bias is not None and data.dtype in _LOW
    out = op(x, w, None if late else bias, *args)
    if late:
        out = out + bias.reshape((-1,) + (1,) * nd)
    return out if ax == 1 else out.movedim(1, ax)


def convolution(data, weight, bias=None, stride=None, pad=None, dilate=None,
                num_group=1, layout=None):
    """N-d convolution with symmetric zero padding.  Channel-first data
    ``(N, C, *spatial)`` takes the weight ``(num_filter, C/num_group,
    *kernel)``; channel-last data ``(N, *spatial, C)`` the weight
    ``(num_filter, *kernel, C/num_group)``, and gives channel-last
    output."""
    nd = data.dim() - 2
    return _channel_first_call(_CONV[nd], data, weight, bias, layout,
                               _tuple(stride, nd, 1), _tuple(pad, nd, 0),
                               _tuple(dilate, nd, 1), int(num_group))


def deconvolution(data, weight, bias=None, stride=None, pad=None,
                  dilate=None, adj=None, num_group=1, layout=None):
    """N-d transposed convolution, the gradient of :func:`convolution`
    with respect to its data: each output axis is ``(in - 1) * stride -
    2 * pad + dilate * (kernel - 1) + adj + 1`` long.  Channel-first data
    ``(N, C, *spatial)`` takes the weight ``(C, num_filter / num_group,
    *kernel)``; channel-last data ``(N, *spatial, C)`` the weight ``(C,
    *kernel, num_filter / num_group)`` (the JAX op permutes both by the
    same axes, ``mxnet_tpu/ops/nn.py:127-138``), and gives channel-last
    output."""
    nd = data.dim() - 2
    return _channel_first_call(_CONV_T[nd], data, weight, bias, layout,
                               _tuple(stride, nd, 1), _tuple(pad, nd, 0),
                               _tuple(adj, nd, 0), int(num_group),
                               _tuple(dilate, nd, 1))


def _pool_pads(shape, kernel, stride, pad, convention):
    """(low, high) padding per spatial axis.  ``"full"`` (ceil division)
    adds the extra padding on the high side, as ``_pads`` in the JAX op;
    torch's ``ceil_mode`` follows another edge rule and is not used."""
    if convention not in ("valid", "full"):
        raise ValueError(f"unknown pooling_convention {convention!r}")
    pads = []
    for size, k, s, p in zip(shape, kernel, stride, pad):
        rem = (size + 2 * p - k) % s
        extra = (s - rem) % s if convention == "full" and rem else 0
        pads.append((p, p + extra))
    return pads


def _padded(x, pads, value=0.0):
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


def _window_sum(x, kernel, stride, pads):
    """Sum over each window of ``x`` zero-padded by ``pads`` (1-D as 2-D
    windows one row high: ``avg_pool1d`` takes no divisor)."""
    x = _padded(x, pads)
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            pooling_convention="valid", stride=None, pad=None,
            count_include_pad=True, layout=None):
    """Max/avg/sum pooling over the 1, 2 or 3 spatial axes of
    channel-first (NCW/NCHW/NCDHW) or channel-last (NWC/NHWC/NDHWC) data,
    windowed or global.

    Padding is filled with the reduction's identity (-inf for max, 0 for
    the sums); ``avg`` divides by the window size when
    ``count_include_pad`` (extra ``"full"`` padding included, as the
    reference does) and by the count of real elements otherwise.
    Channel-last data pools a channel-first view (``channels_last`` in
    2-D, a format torch's pooling and padding keep) and returns
    contiguous channel-last data."""
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    if data.dim() not in (3, 4, 5):
        raise ValueError(f"pooling takes 1-, 2- or 3-D data with batch and "
                         f"channel axes, got {tuple(data.shape)}")
    nd = data.dim() - 2
    ax = _channel_axis(layout, data.dim())
    if parse_bool(global_pool):
        spatial = tuple(i for i in range(1, data.dim()) if i != ax)
        reduce = {"max": torch.amax, "avg": torch.mean, "sum": torch.sum}
        return reduce[pool_type](data, dim=spatial, keepdim=True)
    if ax not in (1, nd + 1):
        raise ValueError(f"layout {layout!r}: the channel axis must be "
                         f"second or last")
    x = _to_channel_first(data, ax)
    out = _pool(x, _tuple(kernel, nd, 1), _tuple(stride, nd, 1),
                _tuple(pad, nd, 0), pool_type, pooling_convention,
                count_include_pad)
    # 1-D has no channels-last format, and 3-D sums lose it: one copy
    return out if ax == 1 else out.movedim(1, ax).contiguous()


def _pool(x, kernel, stride, pad, pool_type, convention, count_include_pad):
    pads = _pool_pads(x.shape[2:], kernel, stride, pad, convention)
    if pool_type == "max":
        pool = _MAX_POOL[len(kernel)]
        if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
            # torch pads with -inf itself: no padded copy of the input
            return pool(x, kernel, stride, pad)
        return pool(_padded(x, pads, float("-inf")), kernel, stride)
    s = _window_sum(x, kernel, stride, pads)
    if pool_type == "sum":
        return s
    if count_include_pad:
        return s / math.prod(kernel)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return s / _window_sum(ones, kernel, stride, pads)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               fix_gamma=True, axis=1, training=False):
    """BatchNorm over ``axis``: ``(x - mean) / sqrt(var + eps) * gamma +
    beta``, gamma read as one when ``fix_gamma``.

    Inference (``training=False``) normalises with the moving statistics
    and returns the output only.  Training normalises with the batch
    statistics, as ``mxnet_tpu/ops/nn.py:284-305`` does, and returns
    ``(out, mean, var)`` (``var`` biased).  The statistics come from the
    bn-stats kernel (``ops/bn_stats.py``), one launch, with the pivot, the
    first element of each channel (``x[0, c, 0, 0]``, ``x[0, 0, 0, c]`` in
    NHWC), as its shift, read by the kernel itself (``bn_stats.FIRST``);
    ``out``'s gradient flows through them (the pivot is a constant).  The
    statistics read the activation as it lies when the channel axis is 1
    of a contiguous tensor or the innermost one (NHWC, ``channels_last``):
    the kernel's two layouts.  Any other input is
    copied to contiguous channel-first once, on every device, counted in
    ``bn_stats.copies``.
    The moving statistics are not touched: see
    :func:`update_moving_stats`."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    ax = axis % data.dim()
    if not training:
        x = _to_channel_first(data, ax)
        out = F.batch_norm(x, moving_mean, moving_var, g, beta,
                           training=False, eps=float(eps))
        return out if ax == 1 else out.movedim(1, ax)
    x, xax = data, ax
    if _bs.layout(data, ax) is None:
        x, xax = _to_channel_first(data, ax).contiguous(), 1
        _bs.bn_stats.copies += 1
    # the kernel reads its pivot, each channel's first element, itself
    mean32, var32 = _bs.batch_stats(x, _bs.FIRST, xax)
    mean, var = mean32.to(data.dtype), var32.to(data.dtype)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    inv = torch.rsqrt(var.float() + eps).to(data.dtype)
    out = (data - mean.reshape(shape)) * (inv * g.to(data.dtype)).reshape(
        shape) + beta.to(data.dtype).reshape(shape)
    # the statistics flow into ``out``'s gradient; as returned they carry
    # none, as in JAX (``stop_gradient`` at mxnet_tpu/ops/nn.py:311)
    return out, mean.detach(), var.detach()


@torch.no_grad()
def update_moving_stats(moving_mean, moving_var, mean, var, momentum=0.9):
    """``moving = momentum * moving + (1 - momentum) * batch`` in place, for
    the mean and the biased variance (the write-back of
    ``mxnet_tpu/ndarray/register.py:33-42``)."""
    for moving, batch in ((moving_mean, mean), (moving_var, var)):
        moving.mul_(momentum).add_(batch.to(moving.dtype) * (1 - momentum))


_ACT = {"relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "softrelu": F.softplus, "softsign": F.softsign}


def activation(data, act_type="relu"):
    """``Activation``: relu, sigmoid, tanh, softrelu (softplus), softsign."""
    if act_type not in _ACT:
        raise ValueError(f"unknown act_type {act_type!r}")
    return _ACT[act_type](data)


def flatten(data):
    """``(N, ...) -> (N, prod(...))``."""
    return data.reshape(data.shape[0], -1)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             blank_label="first"):
    """Connectionist temporal classification loss, one per sequence: the
    forward algorithm in log space over ``data`` ``(T, N, alphabet)``
    (unnormalised scores; log-softmax taken here), as the JAX op
    (``mxnet_tpu/ops/nn.py:619-679``) runs it.

    ``blank_label`` ``"first"`` makes 0 the blank and 0 the labels'
    padding; ``"last"`` makes ``alphabet - 1`` the blank and -1 the
    padding.  A label's length is its count of non-padding entries
    unless ``label_lengths`` is given; ``data_lengths`` stops each
    sequence's recursion early.  Differentiable through torch's
    autograd."""
    seq_len, batch, nalpha = data.shape
    blank = 0 if blank_label == "first" else nalpha - 1
    logp = torch.log_softmax(data, dim=-1)
    lab = label.long()
    ext = torch.full((batch, 2 * lab.shape[1] + 1), blank, dtype=torch.long,
                     device=data.device)
    ext[:, 1::2] = lab
    # padding (-1) reads the last class, as the JAX gather's index does
    idx = ext.remainder(nalpha)
    if label_lengths is None:
        lab_len = (lab > 0 if blank == 0 else lab >= 0).sum(dim=1)
    else:
        lab_len = label_lengths.long()
    if data_lengths is None:
        data_len = torch.full((batch,), seq_len, device=data.device)
    else:
        data_len = data_lengths.long()
    skip = (ext != blank) & (ext != F.pad(ext, (2, 0), value=-1)[:, :-2])
    neg = torch.full((batch, 1), -1e30, dtype=logp.dtype, device=data.device)
    alpha = torch.cat([logp[0, :, blank:blank + 1],
                       logp[0].gather(1, idx[:, 1:2]),
                       neg.expand(batch, ext.shape[1] - 2)], dim=1)
    for t in range(1, seq_len):
        shift1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        cand = torch.logaddexp(alpha, shift1)
        cand = torch.where(skip, torch.logaddexp(cand, shift2), cand)
        new = cand + logp[t].gather(1, idx)
        alpha = torch.where((t < data_len)[:, None], new, alpha)
    last = (2 * lab_len)[:, None]
    return -torch.logaddexp(alpha.gather(1, last),
                            alpha.gather(1, (last - 1).clamp_min(0)))[:, 0]


# --------------------------------------------------------------- op table
# The functions above under the JAX package's op names and attributes
# (``mxnet_tpu/ops/nn.py``), for ``mx.nd``.  ``BatchNorm`` returns ``(out,
# mean, var)``: the batch statistics in training (``__training__``, passed
# by the frontend, and not ``use_global_stats``), which the frontend folds
# into the moving ones in place, else the moving statistics themselves.
def _bias(bias, no_bias):
    return bias[0] if bias and not parse_bool(no_bias) else None


@register("FullyConnected")
def _fully_connected_op(data, weight, *bias, num_hidden=None, no_bias=False,
                        flatten=True):
    return fully_connected(data, weight, _bias(bias, no_bias),
                           parse_bool(flatten, True))


@register("Convolution")
def _convolution_op(data, weight, *bias, kernel=None, stride=None,
                    dilate=None, pad=None, num_filter=None, num_group=1,
                    workspace=1024, no_bias=False, cudnn_tune=None,
                    cudnn_off=False, layout=None):
    nd = data.dim() - 2
    return convolution(data, weight, _bias(bias, no_bias),
                       parse_tuple(stride, nd), parse_tuple(pad, nd),
                       parse_tuple(dilate, nd), parse_int(num_group, 1),
                       layout)


@register("Deconvolution")
def _deconvolution_op(data, weight, *bias, kernel=None, stride=None,
                      dilate=None, pad=None, adj=None, target_shape=None,
                      num_filter=None, num_group=1, workspace=512,
                      no_bias=True, cudnn_tune=None, cudnn_off=False,
                      layout=None):
    """MXNet's ``Deconvolution``; ``no_bias`` defaults to True, unlike
    ``Convolution``'s.  ``target_shape`` (MXNet derives pad and adj from
    it; the JAX op takes it and reads nothing of it) is not ported: a
    nonzero one raises."""
    if any(parse_tuple(target_shape) or ()):
        raise NotImplementedError(
            "Deconvolution(target_shape=...) is not ported (ROADMAP.md, "
            "queue 1 item 2); give pad and adj")
    nd = data.dim() - 2
    b = bias[0] if bias and not parse_bool(no_bias, True) else None
    return deconvolution(data, weight, b, parse_tuple(stride, nd),
                         parse_tuple(pad, nd), parse_tuple(dilate, nd),
                         parse_tuple(adj, nd), parse_int(num_group, 1),
                         layout)


@register("Pooling")
def _pooling_op(data, kernel=None, pool_type="max", global_pool=False,
                cudnn_off=False, pooling_convention="valid", stride=None,
                pad=None, p_value=2, count_include_pad=True, layout=None):
    """``lp`` pools ``sum(|x|^p)^(1/p)``; the others are :func:`pooling`."""
    nd = data.dim() - 2
    kw = dict(global_pool=parse_bool(global_pool),
              pooling_convention=str(pooling_convention),
              stride=parse_tuple(stride, nd), pad=parse_tuple(pad, nd),
              count_include_pad=parse_bool(count_include_pad, True),
              layout=layout)
    kernel = parse_tuple(kernel, nd)
    if pool_type != "lp":
        return pooling(data, kernel, pool_type, **kw)
    p = parse_float(p_value, 2)
    s = pooling(torch.abs(data) ** p, kernel, "sum", **kw)
    return s ** (1.0 / p)


@register("BatchNorm")
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   min_calib_range=None, max_calib_range=None,
                   __training__=False):
    kw = dict(eps=parse_float(eps, 1e-3),
              fix_gamma=parse_bool(fix_gamma, True), axis=parse_int(axis, 1))
    if parse_bool(__training__) and not parse_bool(use_global_stats):
        return batch_norm(data, gamma, beta, moving_mean, moving_var,
                          training=True, **kw)
    out = batch_norm(data, gamma, beta, moving_mean, moving_var, **kw)
    return out, moving_mean, moving_var


@register("LayerNorm")
def _layer_norm_op(data, gamma, beta, axis=-1, eps=1e-5,
                   output_mean_var=False):
    ax, eps = parse_int(axis, -1), parse_float(eps, 1e-5)
    out = layer_norm(data, gamma, beta, ax, eps)
    if not parse_bool(output_mean_var):
        return out
    x = data.float()
    return out, x.mean(dim=ax), x.var(dim=ax, unbiased=False)



@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    """``InstanceNorm`` (``mxnet_tpu/ops/nn.py:387``): each sample's
    channels normalised over their spatial axes (biased variance), then
    ``gamma``/``beta`` on axis 1."""
    eps = parse_float(eps, 1e-3)
    var, mean = torch.var_mean(data, dim=tuple(range(2, data.dim())),
                               keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)

def _temper(data, temperature):
    return data if temperature is None else data / parse_float(temperature)


@register("softmax")
def _softmax_op(data, *length, axis=-1, temperature=None, dtype=None,
                use_length=False):
    if parse_bool(use_length):
        raise NotImplementedError("softmax(use_length=True) is not ported "
                                  "(ROADMAP.md, queue 1)")
    out = softmax(_temper(data, temperature), parse_int(axis, -1))
    return out if dtype is None else out.to(torch_dtype(dtype))


@register("log_softmax")
def _log_softmax_op(data, axis=-1, temperature=None, dtype=None,
                    use_length=False):
    return torch.log_softmax(_temper(data, temperature), parse_int(axis, -1))


@register("softmin")
def _softmin_op(data, axis=-1, temperature=None, dtype=None,
                use_length=False):
    return torch.softmax(-data, parse_int(axis, -1))


@register("Dropout")
def _dropout_op(data, p=0.5, mode="training", axes=None, cudnn_off=False,
                __training__=False, generator=None):
    """Inverted dropout in training (or ``mode="always"``), with a mask
    shared along ``axes``, drawn from ``generator``."""
    p = parse_float(p, 0.5)
    if not (parse_bool(__training__) or mode == "always") or p == 0.0:
        return data.clone()
    shape = list(data.shape)
    for a in parse_tuple(axes) or ():
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=data.dtype, device=data.device) \
        .bernoulli_(keep, generator=generator)
    return data * mask / keep


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward of MXNet's loss layer
    (``src/operator/softmax_output-inl.h``), which ignores the head
    gradient: ``(softmax - target) * grad_scale / normalization``, the
    target being the one-hot label, or with ``smooth_alpha`` the label
    smoothed to ``1 - alpha`` and ``alpha / (k - 1)``."""

    @staticmethod
    def forward(ctx, data, label, axis, flat, grad_scale, ignore_label,
                use_ignore, normalization, smooth_alpha):
        x = data.reshape(data.shape[0], -1) if flat else data
        out = torch.softmax(x, dim=axis).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.attrs = (axis, flat, grad_scale, ignore_label, use_ignore,
                     normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        (axis, flat, scale, ignore_label, use_ignore, normalization,
         alpha) = ctx.attrs
        prob = out.reshape(out.shape[0], -1) if flat else out
        k = prob.shape[axis]
        lab = label.reshape(prob.shape[:axis] + prob.shape[axis + 1:]) \
            if flat else label
        onehot = F.one_hot(lab.long().clamp(0, k - 1), k).to(out.dtype) \
            .movedim(-1, axis)
        if alpha:
            onehot = onehot * (1.0 - alpha - alpha / (k - 1)) + alpha / (k - 1)
        grad = prob - onehot
        keep = lab != ignore_label
        if use_ignore:
            grad = grad * keep.unsqueeze(axis).to(out.dtype)
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            grad = grad / keep.sum().clamp_min(1).to(out.dtype)
        grad = (grad * scale).reshape(out.shape)
        lgrad = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad, lgrad, None, None, None, None, None, None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output_op(data, label, grad_scale=1.0, ignore_label=-1.0,
                       multi_output=False, use_ignore=False,
                       preserve_shape=False, normalization="null",
                       out_grad=False, smooth_alpha=0.0):
    """MXNet's softmax loss head (``mxnet_tpu/ops/nn.py:467``): the output
    is the softmax of ``data``, over axis 1 with ``multi_output``, over the
    last axis with ``preserve_shape``, else over all axes after the first
    (the reference flattens ``data`` to 2-D).  Its gradient is
    :class:`_SoftmaxOutput`'s, whatever the head gradient; ``label`` takes
    zeros.  ``normalization`` divides by the batch (``"batch"``) or, with
    ``use_ignore``, by the count of labels that are not ``ignore_label``
    (``"valid"``), as the JAX op does.  Two departures from the JAX op,
    which ignores these attributes: ``preserve_shape`` and ``smooth_alpha``
    act as in the reference."""
    multi = parse_bool(multi_output)
    preserve = parse_bool(preserve_shape)
    axis = 1 if multi else (data.dim() - 1 if preserve else 1)
    flat = not multi and not preserve and data.dim() > 2
    return _SoftmaxOutput.apply(
        data, label, axis, flat, parse_float(grad_scale, 1.0),
        parse_float(ignore_label, -1.0), parse_bool(use_ignore),
        str(normalization), parse_float(smooth_alpha, 0.0))


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"))
def _ctc_loss_op(data, label, *lengths, use_data_lengths=False,
                 use_label_lengths=False, blank_label="first"):
    """MXNet's ``CTCLoss``: the optional inputs after ``label`` are the
    data lengths (with ``use_data_lengths``), then the label lengths
    (with ``use_label_lengths``)."""
    use_data = parse_bool(use_data_lengths)
    data_lengths = lengths[0] if use_data and lengths else None
    label_lengths = lengths[-1] if parse_bool(use_label_lengths) and \
        len(lengths) > (1 if use_data else 0) else None
    return ctc_loss(data, label, data_lengths, label_lengths,
                    str(blank_label))
