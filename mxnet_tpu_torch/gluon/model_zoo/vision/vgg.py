"""VGG 11/13/16/19, with and without BatchNorm (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``; Simonyan and Zisserman
1409.1556).

The JAX net's blocks in its order and scopes, so ``collect_params()``
gives its names (``vgg0_conv0_weight``) and its ``save_parameters`` file
loads here as it is.  The ``_bn`` variants put a ``BatchNorm`` after every
convolution: in training its statistics run on the bn-stats kernel.
``device=None`` means the current context (the GPU).
"""
from __future__ import annotations

from ....context import as_device
from ...block import HybridBlock
from ... import nn
from .alexnet import PRETRAINED

__all__ = ["VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]


class VGG(HybridBlock):
    """``layers[i]`` 3x3 convolutions of ``filters[i]`` channels a stage,
    each stage closed by a 2x2 max pool, then three fully-connected
    layers."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 device=None, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if len(layers) != len(filters):
            raise ValueError("one filter count per stage")
        device = as_device(device)
        with self.name_scope():
            self.features = self._make_features(layers, filters,
                                                batch_norm, device)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       device=device))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       device=device))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   device=device)

    @staticmethod
    def _make_features(layers, filters, batch_norm, device):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1,
                                         weight_initializer="xavier",
                                         device=device))
                if batch_norm:
                    featurizer.add(nn.BatchNorm(device=device))
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root="~/.mxnet/models",
            **kwargs):
    """VGG of ``num_layers``, uninitialised (``pretrained=True``
    raises)."""
    if num_layers not in vgg_spec:
        raise ValueError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(vgg_spec)}")
    if pretrained:
        raise NotImplementedError(PRETRAINED)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
