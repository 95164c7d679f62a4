"""MobileNet V1 (Howard et al. 1704.04861) and V2 (Sandler et al.
1801.04381) (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/
mobilenet.py``).

The JAX nets' blocks in their order and scopes, so ``collect_params()``
gives their names (``mobilenetv20_features_linearbottleneck0_
batchnorm0_gamma``) and their ``save_parameters`` files load here as they
are.  Depthwise convolutions are grouped ones with ``groups`` equal to
the channels (cuDNN's depthwise kernels); ReLU6 is ``clip(x, 0, 6)``;
every convolution is followed by a ``BatchNorm`` (in training one bn-stats
launch each: 27 a MobileNet forward, 53 a MobileNet V2 one).
``device=None`` means the current context (the GPU).
"""
from __future__ import annotations

from ....context import as_device
from ...block import HybridBlock
from ... import nn
from .alexnet import PRETRAINED

__all__ = ["MobileNet", "MobileNetV2", "get_mobilenet", "get_mobilenet_v2",
           "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25"]


class RELU6(HybridBlock):
    """``min(max(x, 0), 6)``."""

    def forward(self, x):
        return x.clamp(0, 6)

    def hybrid_forward(self, F, x):
        return F.clip(x, 0, 6, name="relu6")


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False, device=None):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False, device=device))
    out.add(nn.BatchNorm(scale=True, device=device))
    if active:
        out.add(RELU6() if relu6 else nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False,
                 device=None):
    _add_conv(out, channels=dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6, device=device)
    _add_conv(out, channels=channels, relu6=relu6, device=device)


class LinearBottleneck(HybridBlock):
    """MobileNet V2's inverted residual: expand 1x1, depthwise 3x3,
    project 1x1 (linear); the input is added when the stride is 1 and the
    widths match."""

    def __init__(self, in_channels, channels, t, stride, device=None, *,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True, device=device)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True,
                      device=device)
            _add_conv(self.out, channels, active=False, relu6=True,
                      device=device)

    def forward(self, x):
        out = self.out(x)
        return out + x if self.use_shortcut else out

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = F.elemwise_add(out, x)
        return out


class MobileNet(HybridBlock):
    """MobileNet V1 of width ``multiplier``: a stem and 13 depthwise
    separable blocks, global average pool, classifier."""

    def __init__(self, multiplier=1.0, classes=1000, device=None, *,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, channels=int(32 * multiplier),
                          kernel=3, pad=1, stride=2, device=device)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                               + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6
                            + [1024] * 2]
                strides = [1, 2] * 3 + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dw_channels=dwc, channels=c,
                                 stride=s, device=device)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, device=device)

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """MobileNet V2 of width ``multiplier``: a stem, 17 linear
    bottlenecks, a 1280-channel 1x1 convolution, global average pool and
    a 1x1 convolution to the classes."""

    def __init__(self, multiplier=1.0, classes=1000, device=None, *,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True, device=device)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3
                                     + [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4
                                  + [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(LinearBottleneck(
                        in_channels=in_c, channels=c, t=t, stride=s,
                        device=device))
                last_channels = int(1280 * multiplier) if multiplier > 1.0 \
                    else 1280
                _add_conv(self.features, last_channels, relu6=True,
                          device=device)
                self.features.add(nn.GlobalAvgPool2D())

            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(
                    nn.Conv2D(classes, 1, use_bias=False, prefix="pred_",
                              device=device),
                    nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None,
                  root="~/.mxnet/models", **kwargs):
    """MobileNet V1 of width ``multiplier``, uninitialised
    (``pretrained=True`` raises)."""
    if pretrained:
        raise NotImplementedError(PRETRAINED)
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None,
                     root="~/.mxnet/models", **kwargs):
    """MobileNet V2 of width ``multiplier``, uninitialised
    (``pretrained=True`` raises)."""
    if pretrained:
        raise NotImplementedError(PRETRAINED)
    return MobileNetV2(multiplier, **kwargs)


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)
