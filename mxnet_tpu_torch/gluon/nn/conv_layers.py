"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``: ``_Conv``/``Conv2D`` :24, :153 and
the pooling layers :246-403).

Channel-first layouts only; ``layout="NHWC"`` raises (ROADMAP.md).  The
weight is ``(channels, in_channels / groups, *kernel)``; ``in_channels=0``
defers it to the first forward or to ``load_parameters``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import nn as ops
from ...ops.registry import amp_inputs
from ..block import HybridBlock, is_deferred
from .activations import Activation
from .basic_layers import _param

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _check_layout(layout, channel_first):
    if layout != channel_first:
        raise NotImplementedError(
            f"layout {layout!r}: the port takes {channel_first} only; "
            f"channel-last layouts are queued in ROADMAP.md")


class _Conv(HybridBlock):
    """Base convolution layer."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, in_channels=0, activation=None, use_bias=True,
                 dtype=torch.float32, device=None):
        super().__init__()
        nd = len(kernel_size)
        self._channels = channels
        self._kernel = tuple(kernel_size)
        self._stride = ops._tuple(strides, nd, 1)
        self._pad = ops._tuple(padding, nd, 0)
        self._dilate = ops._tuple(dilation, nd, 1)
        self._groups = groups
        self.weight = _param((channels, in_channels // groups)
                             + self._kernel, dtype, device)
        self.bias = nn.Parameter(torch.empty(channels, dtype=dtype,
                                             device=device)) \
            if use_bias else None
        self.act = Activation(activation) if activation is not None \
            else None

    def forward(self, x):
        if is_deferred(self.weight):
            self._materialize(
                {"weight": (self._channels, x.shape[1] // self._groups)
                 + self._kernel}, x.device)
        x, w, b = amp_inputs("Convolution", x, self.weight, self.bias)
        y = ops.convolution(x, w, b, self._stride, self._pad, self._dilate,
                            self._groups)
        return y if self.act is None else self.act(y)


class Conv2D(_Conv):
    """2-D convolution over NCHW data."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, in_channels=0, dtype=torch.float32,
                 device=None):
        _check_layout(layout, "NCHW")
        super().__init__(channels, ops._tuple(kernel_size, 2, 1), strides,
                         padding, dilation, groups, in_channels, activation,
                         use_bias, dtype, device)


class _Pooling(HybridBlock):
    """Base pooling layer; ``ceil_mode`` is the op's ``"full"``
    convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", count_include_pad=True):
        super().__init__()
        nd = len(pool_size)
        self._kwargs = {
            "kernel": tuple(pool_size),
            "stride": ops._tuple(pool_size if strides is None else strides,
                                 nd, 1),
            "pad": ops._tuple(padding, nd, 0), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "count_include_pad": count_include_pad}

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    """2-D max pooling over NCHW data."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        _check_layout(layout, "NCHW")
        super().__init__(ops._tuple(pool_size, 2, 1), strides, padding,
                         ceil_mode, False, "max")


class AvgPool2D(_Pooling):
    """2-D average pooling over NCHW data."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCHW", count_include_pad=True):
        _check_layout(layout, "NCHW")
        super().__init__(ops._tuple(pool_size, 2, 1), strides, padding,
                         ceil_mode, False, "avg", count_include_pad)


class GlobalAvgPool2D(_Pooling):
    """Mean over H and W, keeping them as 1."""

    def __init__(self, layout="NCHW"):
        _check_layout(layout, "NCHW")
        super().__init__((1, 1), None, 0, True, True, "avg")
