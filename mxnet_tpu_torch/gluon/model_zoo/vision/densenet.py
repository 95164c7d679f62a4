"""DenseNet 121/161/169/201 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``; Huang et al.
1608.06993).

The JAX net's blocks in its order and scopes, so ``collect_params()``
gives its names (a stage's layers share its scope:
``densenet0_stage1_batchnorm0_gamma``) and its ``save_parameters`` file
loads here as it is.  Each dense layer concatenates its input with its
``growth_rate`` new channels, so every BatchNorm of a stage sees a wider
input than the one before (in training: one bn-stats launch each, 121 a
DenseNet-121 forward).  ``device=None`` means the current context (the
GPU).
"""
from __future__ import annotations

import torch

from ....context import as_device
from ...block import HybridBlock
from ... import nn
from .alexnet import PRETRAINED

__all__ = ["DenseNet", "get_densenet", "densenet121", "densenet161",
           "densenet169", "densenet201"]


class _DenseLayer(HybridBlock):
    """BN-ReLU-Conv1x1, BN-ReLU-Conv3x3; the output is the input
    concatenated with the ``growth_rate`` channels the body makes."""

    def __init__(self, growth_rate, bn_size, dropout, device=None, *,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        # made in the enclosing scope, as the JAX layer makes it
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm(device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False, device=device))
        self.body.add(nn.BatchNorm(device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False, device=device))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        return torch.cat([x, self.body(x)], dim=1)

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index, device):
    out = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout, device))
    return out


def _make_transition(num_output_features, device):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm(device=device))
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False,
                      device=device))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    """Stem, ``len(block_config)`` dense blocks with a halving transition
    between two, final BatchNorm and ReLU, a 7x7 average pool (224x224
    input), classifier."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, device=None, *,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3,
                                        use_bias=False, device=device))
            self.features.add(nn.BatchNorm(device=device))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1,
                    device))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2,
                                                       device))
                    num_features = num_features // 2
            self.features.add(nn.BatchNorm(device=device))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, device=device)

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, ctx=None,
                 root="~/.mxnet/models", **kwargs):
    """DenseNet of ``num_layers``, uninitialised (``pretrained=True``
    raises)."""
    if num_layers not in densenet_spec:
        raise ValueError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(densenet_spec)}")
    if pretrained:
        raise NotImplementedError(PRETRAINED)
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
