"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``: ``_Conv``/``Conv1D``/``Conv2D``/
``Conv3D`` :24-200 and the 2-D pooling layers :246-403).

Channel-first and channel-last layouts, as the JAX package: the weight
follows the data's layout, ``(channels, in_channels / groups, *kernel)``
for NCW/NCHW/NCDHW and ``(channels, *kernel, in_channels / groups)`` for
NWC/NHWC/NDHWC (``mxnet_tpu/gluon/nn/conv_layers.py:70-89``), so a JAX
``.params`` file of either layout loads as it is.  ``in_channels=0``
defers the weight to the first forward or to ``load_parameters``.  Each
layer takes the JAX package's arguments in its order, with its defaults,
but for ``prefix`` and ``params``; ``dtype`` (a name or a ``torch.dtype``)
and ``device`` are keyword only.
Pooling is 2-D only (NCHW, NHWC); 1-D and 3-D pooling wait for ROADMAP.md
queue 1 item 6, as the transposed convolutions do.
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import torch_dtype
from ...ops import nn as ops
from ...ops.registry import amp_inputs
from ..block import HybridBlock, is_deferred
from .activations import Activation
from .basic_layers import _param

__all__ = ["Conv1D", "Conv2D", "Conv3D", "MaxPool2D", "AvgPool2D",
           "GlobalAvgPool2D"]


def _check_layout(layout, allowed):
    if layout not in allowed:
        raise ValueError(f"layout {layout!r}: must be one of {allowed}")


class _Conv(HybridBlock):
    """Base convolution layer."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype=torch.float32, device=None):
        super().__init__()
        dtype = torch_dtype(dtype)
        nd = len(kernel_size)
        self._channels = channels
        self._kernel = tuple(kernel_size)
        self._stride = ops._tuple(strides, nd, 1)
        self._pad = ops._tuple(padding, nd, 0)
        self._dilate = ops._tuple(dilation, nd, 1)
        self._groups = groups
        self._layout = layout
        self._caxis = layout.index("C")
        self.weight = _param(self._weight_shape(in_channels), dtype, device)
        self.bias = nn.Parameter(torch.empty(channels, dtype=dtype,
                                             device=device)) \
            if use_bias else None
        self._param_inits = {"weight": weight_initializer,
                             "bias": bias_initializer}
        self.act = Activation(activation) if activation is not None \
            else None

    def _weight_shape(self, in_channels):
        ic = in_channels // self._groups
        if self._caxis == 1:
            return (self._channels, ic) + self._kernel
        return (self._channels,) + self._kernel + (ic,)

    def forward(self, x):
        if is_deferred(self.weight):
            self._materialize(
                {"weight": self._weight_shape(x.shape[self._caxis])},
                x.device)
        x, w, b = amp_inputs("Convolution", x, self.weight, self.bias)
        y = ops.convolution(x, w, b, self._stride, self._pad, self._dilate,
                            self._groups, self._layout)
        return y if self.act is None else self.act(y)


class Conv1D(_Conv):
    """1-D convolution over NCW or NWC data."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *,
                 dtype=torch.float32, device=None):
        _check_layout(layout, ("NCW", "NWC"))
        super().__init__(channels, ops._tuple(kernel_size, 1, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype, device)


class Conv2D(_Conv):
    """2-D convolution over NCHW or NHWC data."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *,
                 dtype=torch.float32, device=None):
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(channels, ops._tuple(kernel_size, 2, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype, device)


class Conv3D(_Conv):
    """3-D convolution over NCDHW or NDHWC data."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, *, dtype=torch.float32, device=None):
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(channels, ops._tuple(kernel_size, 3, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype, device)


class _Pooling(HybridBlock):
    """Base pooling layer; ``ceil_mode`` is the op's ``"full"``
    convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", count_include_pad=True,
                 layout="NCHW"):
        super().__init__()
        _check_layout(layout, ("NCHW", "NHWC"))
        nd = len(pool_size)
        self._kwargs = {
            "kernel": tuple(pool_size),
            "stride": ops._tuple(pool_size if strides is None else strides,
                                 nd, 1),
            "pad": ops._tuple(padding, nd, 0), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "count_include_pad": count_include_pad, "layout": layout}

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    """2-D max pooling over NCHW or NHWC data."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(ops._tuple(pool_size, 2, 1), strides, padding,
                         ceil_mode, False, "max", layout=layout)


class AvgPool2D(_Pooling):
    """2-D average pooling over NCHW or NHWC data."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCHW", count_include_pad=True):
        super().__init__(ops._tuple(pool_size, 2, 1), strides, padding,
                         ceil_mode, False, "avg", count_include_pad, layout)


class GlobalAvgPool2D(_Pooling):
    """Mean over H and W, keeping them as 1."""

    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "avg", layout=layout)
