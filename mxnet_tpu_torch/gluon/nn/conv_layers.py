"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``: ``_Conv``/``Conv1D``/``Conv2D``/
``Conv3D`` :24-182, the transposed ``Conv1DTranspose``/
``Conv2DTranspose``/``Conv3DTranspose`` :184-244, the 1-, 2- and 3-D
pooling layers :246-409, ``ReflectionPad2D`` :412-423).

Channel-first and channel-last layouts, as the JAX package: the weight
follows the data's layout, ``(channels, in_channels / groups, *kernel)``
for NCW/NCHW/NCDHW and ``(channels, *kernel, in_channels / groups)`` for
NWC/NHWC/NDHWC (``mxnet_tpu/gluon/nn/conv_layers.py:70-89``), so a JAX
``.params`` file of either layout loads as it is.  ``in_channels=0``
defers the weight to the first forward or to ``load_parameters``.  Each
layer takes the JAX package's arguments in its order, with its defaults;
``prefix``, ``params``, ``dtype`` (a name or a ``torch.dtype``) and
``device`` are keyword only.  A convolution's alias is ``conv``
(``conv0_weight``), a pool's ``pool``.
A transposed convolution's weight is ``(in_channels, channels / groups,
*kernel)``, ``(in_channels, *kernel, channels / groups)`` channel-last
(the ``Deconvolution`` op's), and ``output_padding`` is the op's
``adj``.
"""
from __future__ import annotations

import torch

from ...base import torch_dtype
from ...ops import matrix
from ...ops import nn as ops
from ...ops.registry import amp_inputs
from ..block import HybridBlock, is_deferred
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _check_layout(layout, allowed):
    if layout not in allowed:
        raise ValueError(f"layout {layout!r}: must be one of {allowed}")


class _Conv(HybridBlock):
    """Base convolution layer: the ``Convolution`` op (``_op``), or the
    ``Deconvolution`` op in :class:`_ConvTranspose`."""

    _op = "Convolution"

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype=torch.float32, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
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
        self.weight = self._new_param("weight",
                                      self._weight_shape(in_channels),
                                      dtype, device,
                                      init=weight_initializer)
        self.bias = self._new_param("bias", (channels,), dtype, device,
                                    init=bias_initializer) \
            if use_bias else None
        with self.name_scope():
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _alias(self):
        return "conv"

    def _weight_shape(self, in_channels):
        ic = in_channels // self._groups
        if self._caxis == 1:
            return (self._channels, ic) + self._kernel
        return (self._channels,) + self._kernel + (ic,)

    def forward(self, x):
        w = self._parameters["weight"]
        if is_deferred(w):
            self.weight._finish_deferred_init(
                self._weight_shape(x.shape[self._caxis]), x.device)
        x, w, b = amp_inputs(self._op, x, w, self._parameters.get("bias"))
        y = self._conv(x, w, b)
        return y if self.act is None else self.act(y)

    def _conv(self, x, w, b):
        return ops.convolution(x, w, b, self._stride, self._pad,
                               self._dilate, self._groups, self._layout)

    def _op_attrs(self):
        return {}

    def hybrid_forward(self, F, x, weight, bias=None):
        args = (x, weight) if bias is None else (x, weight, bias)
        y = getattr(F, self._op)(*args, kernel=self._kernel,
                                 stride=self._stride, dilate=self._dilate,
                                 pad=self._pad, num_filter=self._channels,
                                 num_group=self._groups,
                                 no_bias=bias is None, layout=self._layout,
                                 name="fwd", **self._op_attrs())
        return y if self.act is None else self.act(y)

    def _in_out(self):
        shape = self.weight.shape
        return shape[1] if self._caxis == 1 else shape[-1], shape[0]

    def __repr__(self):
        s = f"{type(self).__name__}("
        cin, cout = self._in_out()
        s += f"{cin or None} -> {cout}, kernel_size={self._kernel}, "
        s += f"stride={self._stride}"
        if any(self._pad):
            s += f", padding={self._pad}"
        if any(getattr(self, "outpad", ())):
            s += f", output_padding={self.outpad}"
        if any(d != 1 for d in self._dilate):
            s += f", dilation={self._dilate}"
        if self._groups != 1:
            s += f", groups={self._groups}"
        if self.bias is None:
            s += ", bias=False"
        if self.act is not None:
            s += f", {self.act!r}"
        return s + ")"


class Conv1D(_Conv):
    """1-D convolution over NCW or NWC data."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, prefix=None,
                 params=None, dtype=torch.float32, device=None):
        _check_layout(layout, ("NCW", "NWC"))
        super().__init__(channels, ops._tuple(kernel_size, 1, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype, device, prefix, params)


class Conv2D(_Conv):
    """2-D convolution over NCHW or NHWC data."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, prefix=None,
                 params=None, dtype=torch.float32, device=None):
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(channels, ops._tuple(kernel_size, 2, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype, device, prefix, params)


class Conv3D(_Conv):
    """3-D convolution over NCDHW or NDHWC data."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, *, prefix=None, params=None,
                 dtype=torch.float32, device=None):
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(channels, ops._tuple(kernel_size, 3, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, dtype, device, prefix, params)


class _ConvTranspose(_Conv):
    """Base transposed convolution: the ``Deconvolution`` op, its weight
    ``(in_channels, channels / groups, *kernel)`` (channel-last ``(
    in_channels, *kernel, channels / groups)``)."""

    _op = "Deconvolution"

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, activation,
                 use_bias, weight_initializer, bias_initializer,
                 in_channels, dtype, device, prefix, params):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype,
                         device, prefix, params)
        self.outpad = ops._tuple(output_padding, len(kernel_size), 0)

    def _weight_shape(self, in_channels):
        oc = self._channels // self._groups
        if self._caxis == 1:
            return (in_channels, oc) + self._kernel
        return (in_channels,) + self._kernel + (oc,)

    def _in_out(self):
        return self.weight.shape[0], self._channels

    def _conv(self, x, w, b):
        return ops.deconvolution(x, w, b, self._stride, self._pad,
                                 self._dilate, self.outpad, self._groups,
                                 self._layout)

    def _op_attrs(self):
        return {"adj": self.outpad}


class Conv1DTranspose(_ConvTranspose):
    """1-D transposed convolution over NCW or NWC data."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, prefix=None,
                 params=None, dtype=torch.float32, device=None):
        _check_layout(layout, ("NCW", "NWC"))
        super().__init__(channels, ops._tuple(kernel_size, 1, 1), strides,
                         padding, output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, dtype, device,
                         prefix, params)


class Conv2DTranspose(_ConvTranspose):
    """2-D transposed convolution over NCHW or NHWC data."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, *, prefix=None, params=None,
                 dtype=torch.float32, device=None):
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(channels, ops._tuple(kernel_size, 2, 1), strides,
                         padding, output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, dtype, device,
                         prefix, params)


class Conv3DTranspose(_ConvTranspose):
    """3-D transposed convolution over NCDHW or NDHWC data."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, prefix=None,
                 params=None, dtype=torch.float32, device=None):
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(channels, ops._tuple(kernel_size, 3, 1), strides,
                         padding, output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, dtype, device,
                         prefix, params)


class _Pooling(HybridBlock):
    """Base pooling layer; ``ceil_mode`` is the op's ``"full"``
    convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", count_include_pad=True,
                 layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        nd = len(pool_size)
        self._kwargs = {
            "kernel": tuple(pool_size),
            "stride": ops._tuple(pool_size if strides is None else strides,
                                 nd, 1),
            "pad": ops._tuple(padding, nd, 0), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "count_include_pad": count_include_pad, "layout": layout}

    def _alias(self):
        return "pool"

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        k = self._kwargs
        return (f"{type(self).__name__}(size={k['kernel']}, "
                f"stride={k['stride']}, padding={k['pad']}, "
                f"ceil_mode={k['pooling_convention'] == 'full'}, "
                f"global_pool={k['global_pool']}, "
                f"pool_type={k['pool_type']})")


class MaxPool1D(_Pooling):
    """1-D max pooling over NCW or NWC data."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, *, prefix=None, params=None):
        _check_layout(layout, ("NCW", "NWC"))
        super().__init__(ops._tuple(pool_size, 1, 1), strides, padding,
                         ceil_mode, False, "max", layout=layout,
                         prefix=prefix, params=params)


class MaxPool2D(_Pooling):
    """2-D max pooling over NCHW or NHWC data."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, *, prefix=None,
                 params=None):
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(ops._tuple(pool_size, 2, 1), strides, padding,
                         ceil_mode, False, "max", layout=layout,
                         prefix=prefix, params=params)


class MaxPool3D(_Pooling):
    """3-D max pooling over NCDHW or NDHWC data."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", *, prefix=None,
                 params=None):
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(ops._tuple(pool_size, 3, 1), strides, padding,
                         ceil_mode, False, "max", layout=layout,
                         prefix=prefix, params=params)


class AvgPool1D(_Pooling):
    """1-D average pooling over NCW or NWC data."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, *, prefix=None,
                 params=None):
        _check_layout(layout, ("NCW", "NWC"))
        super().__init__(ops._tuple(pool_size, 1, 1), strides, padding,
                         ceil_mode, False, "avg", count_include_pad, layout,
                         prefix=prefix, params=params)


class AvgPool2D(_Pooling):
    """2-D average pooling over NCHW or NHWC data."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCHW", count_include_pad=True, *,
                 prefix=None, params=None):
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(ops._tuple(pool_size, 2, 1), strides, padding,
                         ceil_mode, False, "avg", count_include_pad, layout,
                         prefix=prefix, params=params)


class AvgPool3D(_Pooling):
    """3-D average pooling over NCDHW or NDHWC data."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", count_include_pad=True, *,
                 prefix=None, params=None):
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(ops._tuple(pool_size, 3, 1), strides, padding,
                         ceil_mode, False, "avg", count_include_pad, layout,
                         prefix=prefix, params=params)


def _global(pool_type, layouts):
    """A global pooling layer over the spatial axes of ``layouts``."""

    class _GlobalPool(_Pooling):
        def __init__(self, layout=layouts[0], *, prefix=None, params=None):
            _check_layout(layout, layouts)
            nd = len(layout) - 2
            super().__init__((1,) * nd, None, 0, True, True, pool_type,
                             layout=layout, prefix=prefix, params=params)

    return _GlobalPool


class GlobalMaxPool1D(_global("max", ("NCW", "NWC"))):
    """Max over W, keeping it as 1."""


class GlobalMaxPool2D(_global("max", ("NCHW", "NHWC"))):
    """Max over H and W, keeping them as 1."""


class GlobalMaxPool3D(_global("max", ("NCDHW", "NDHWC"))):
    """Max over D, H and W, keeping them as 1."""


class GlobalAvgPool1D(_global("avg", ("NCW", "NWC"))):
    """Mean over W, keeping it as 1."""


class GlobalAvgPool2D(_global("avg", ("NCHW", "NHWC"))):
    """Mean over H and W, keeping them as 1."""


class GlobalAvgPool3D(_global("avg", ("NCDHW", "NDHWC"))):
    """Mean over D, H and W, keeping them as 1."""


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W of NCHW data; ``padding`` is an int or
    MXNet's 8-tuple ``pad_width``."""

    def __init__(self, padding=0, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if len(padding) != 8:
            raise AssertionError("padding must be an int or 8 values")
        self._padding = tuple(padding)

    def forward(self, x):
        return matrix.pad(x, mode="reflect", pad_width=self._padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
