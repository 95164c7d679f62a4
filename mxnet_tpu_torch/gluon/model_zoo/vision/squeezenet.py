"""SqueezeNet 1.0 and 1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``; Iandola et al.
1602.07360).

The JAX net's blocks in its order and scopes, so ``collect_params()``
gives its names and its ``save_parameters`` file loads here as it is.
Its max pools take ``ceil_mode=True`` (the ``"full"`` convention), and a
fire module's two expand paths meet in :class:`HybridConcurrent`, the
JAX file's own (``squeezenet.py:27-40``; Inception-v3 uses it too).
``device=None`` means the current context (the GPU).
"""
from __future__ import annotations

import torch

from ....context import as_device
from ...block import HybridBlock
from ... import nn
from .alexnet import PRETRAINED

__all__ = ["SqueezeNet", "get_squeezenet", "squeezenet1_0",
           "squeezenet1_1"]


class HybridConcurrent(HybridBlock):
    """Runs its children on the same input and concatenates their outputs
    along ``axis`` (Gluon contrib's ``HybridConcurrent``)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, block):
        self.register_child(block)

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self.axis)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels,
               device):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1, 0, device))
    paths = HybridConcurrent(axis=1, prefix="")
    paths.add(_make_fire_conv(expand1x1_channels, 1, 0, device))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1, device))
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding, device):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding, device=device))
    out.add(nn.Activation("relu"))
    return out


class SqueezeNet(HybridBlock):
    """Version ``"1.0"`` or ``"1.1"``: a stem convolution, fire modules
    between ceil-mode max pools, a 1x1 convolution to the classes and a
    13x13 average pool (224x224 input)."""

    def __init__(self, version, classes=1000, device=None, *, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if version not in ("1.0", "1.1"):
            raise ValueError(f"Unsupported SqueezeNet version {version}: "
                             f"1.0 or 1.1 expected")
        device = as_device(device)

        def pool():
            return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)

        def fire(s, e):
            return _make_fire(s, e, e, device)

        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            add = self.features.add
            if version == "1.0":
                add(nn.Conv2D(96, kernel_size=7, strides=2, device=device))
                add(nn.Activation("relu"))
                add(pool())
                add(fire(16, 64))
                add(fire(16, 64))
                add(fire(32, 128))
                add(pool())
                add(fire(32, 128))
                add(fire(48, 192))
                add(fire(48, 192))
                add(fire(64, 256))
                add(pool())
                add(fire(64, 256))
            else:
                add(nn.Conv2D(64, kernel_size=3, strides=2, device=device))
                add(nn.Activation("relu"))
                add(pool())
                add(fire(16, 64))
                add(fire(16, 64))
                add(pool())
                add(fire(32, 128))
                add(fire(32, 128))
                add(pool())
                add(fire(48, 192))
                add(fire(48, 192))
                add(fire(64, 256))
                add(fire(64, 256))
            add(nn.Dropout(0.5))

            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1, device=device))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.AvgPool2D(13))
            self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None,
                   root="~/.mxnet/models", **kwargs):
    """SqueezeNet ``version``, uninitialised (``pretrained=True``
    raises)."""
    if pretrained:
        raise NotImplementedError(PRETRAINED)
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
