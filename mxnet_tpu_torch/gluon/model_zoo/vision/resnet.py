"""ResNet V1/V2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``; He et al. 1512.03385 and
1603.05027).

Same blocks, same child names and so the same structural parameter names
as the JAX package, so a JAX ``save_parameters`` file loads here as it is;
the same prefixes (``resnetv10_``, each stage ``stage{i}_``, the blocks
and the bodies ``prefix=""``;
``mxnet_tpu/gluon/model_zoo/vision/resnet.py:35-241``), so
``collect_params()`` gives the JAX net's names
(``resnetv10_stage1_conv0_weight``).  Each block runs a tensor
``forward`` and carries the reference's ``hybrid_forward`` for
``export``.
As there, the stem convolution and the bottlenecks' 1x1 convolutions are
built with ``in_channels=0`` and take their widths from the first forward
or from ``load_parameters``.  ``layout`` is ``"NCHW"`` or ``"NHWC"``, as
there (``mxnet_tpu/gluon/model_zoo/vision/resnet.py:20-26``): every
convolution and pool takes it and every BatchNorm normalises over
``axis=layout.find("C")``, so an NHWC net runs channel-last end to end
(its training BatchNorms on the bn-stats kernel's channels-last entry)
and loads the JAX package's NHWC ``.params`` file as it is.
``device=None`` means the GPU.
"""
from __future__ import annotations

from ....context import as_device
from ....ops import nn as ops
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels, layout, device):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout,
                     device=device)


def _conv1x1(channels, stride, in_channels, layout, device):
    return nn.Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                     in_channels=in_channels, layout=layout, device=device)


def _bn(layout, device, **kwargs):
    if layout not in ("NCHW", "NHWC"):
        raise ValueError(f"layout {layout!r}: must be NCHW or NHWC")
    return nn.BatchNorm(axis=layout.find("C"), device=device, **kwargs)


def _relu(x):
    return ops.activation(x, "relu")


class BasicBlockV1(HybridBlock):
    """Two 3x3 convolutions and an identity shortcut, post-activation."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout, device))
        self.body.add(_bn(layout, device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout, device))
        self.body.add(_bn(layout, device))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(_conv1x1(channels, stride, in_channels,
                                         layout, device))
            self.downsample.add(_bn(layout, device))
        else:
            self.downsample = None

    def forward(self, x):
        out = self.body(x)            # before the shortcut, as in JAX
        residual = x if self.downsample is None else self.downsample(x)
        return _relu(residual + out)

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1-3x3-1x1 bottleneck, post-activation; the stride is on the first
    1x1."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv1x1(channels // 4, stride, 0, layout, device))
        self.body.add(_bn(layout, device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout,
                               device))
        self.body.add(_bn(layout, device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv1x1(channels, 1, 0, layout, device))
        self.body.add(_bn(layout, device))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(_conv1x1(channels, stride, in_channels,
                                         layout, device))
            self.downsample.add(_bn(layout, device))
        else:
            self.downsample = None

    def forward(self, x):
        out = self.body(x)            # before the shortcut, as in JAX
        residual = x if self.downsample is None else self.downsample(x)
        return _relu(out + residual)

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        self.bn1 = _bn(layout, device)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout, device)
        self.bn2 = _bn(layout, device)
        self.conv2 = _conv3x3(channels, 1, channels, layout, device)
        self.downsample = _conv1x1(channels, stride, in_channels, layout,
                                   device) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = _relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _relu(self.bn2(x))
        return self.conv2(x) + residual

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck; the stride is on the 3x3."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        self.bn1 = _bn(layout, device)
        self.conv1 = _conv1x1(channels // 4, 1, 0, layout, device)
        self.bn2 = _bn(layout, device)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout,
                              device)
        self.bn3 = _bn(layout, device)
        self.conv3 = _conv1x1(channels, 1, 0, layout, device)
        self.downsample = _conv1x1(channels, stride, in_channels, layout,
                                   device) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = _relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _relu(self.bn2(x))
        x = self.conv2(x)
        x = _relu(self.bn3(x))
        return self.conv3(x) + residual

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        return self.conv3(x) + residual


def _stage(block, layers, channels, stride, stage_index, in_channels,
           layout, device):
    """Stage ``stage_index``: a ``HybridSequential`` prefixed
    ``stage{i}_`` whose blocks share its scope (``prefix=""``)."""
    stage = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with stage.name_scope():
        stage.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=layout,
                        device=device, prefix=""))
        for _ in range(layers - 1):
            stage.add(block(channels, 1, False, in_channels=channels,
                            layout=layout, device=device, prefix=""))
    return stage


class ResNetV1(HybridBlock):
    """ResNet V1: stem, four stages, global average pool, classifier."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", device=None, *,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if len(layers) != len(channels) - 1:
            raise ValueError("one channel count per stage plus the stem's")
        device = as_device(device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout,
                                           device))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout,
                                            device=device))
                self.features.add(_bn(layout, device))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                self.features.add(_stage(block, num_layer, channels[i + 1],
                                         1 if i == 0 else 2, i + 1,
                                         channels[i], layout, device))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1],
                                   device=device)

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ResNet V2: input BatchNorm, stem, four pre-activation stages, final
    BatchNorm and ReLU, global average pool, classifier."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", device=None, *,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if len(layers) != len(channels) - 1:
            raise ValueError("one channel count per stage plus the stem's")
        device = as_device(device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_bn(layout, device, scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout,
                                           device))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout,
                                            device=device))
                self.features.add(_bn(layout, device))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                self.features.add(_stage(block, num_layer, channels[i + 1],
                                         1 if i == 0 else 2, i + 1,
                                         in_channels, layout, device))
                in_channels = channels[i + 1]
            self.features.add(_bn(layout, device))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels,
                                   device=device)

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers``, uninitialised (call
    ``initialize(generator=...)`` or ``load_parameters``)."""
    if num_layers not in resnet_spec:
        raise ValueError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version not in (1, 2):
        raise ValueError(f"Invalid resnet version: {version}. Options are "
                         f"1 and 2.")
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not downloaded; use load_parameters "
            "with a local file")
    block_type, layers, channels = resnet_spec[num_layers]
    return resnet_net_versions[version - 1](
        resnet_block_versions[version - 1][block_type], layers, channels,
        **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
