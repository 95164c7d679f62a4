"""Inception V3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; Szegedy et al.
1512.00567).

The JAX net's blocks in its order and scopes, so ``collect_params()``
gives its names (``inception30_A1_conv0_weight``) and its
``save_parameters`` file loads here as it is.  Every convolution is
followed by a ``BatchNorm(epsilon=0.001)`` (94 a forward: in training one
bn-stats launch each, at odd spatial sizes and widths such as 80, 288
and 448); the A-E blocks join their branches in
:class:`~.squeezenet.HybridConcurrent`; the C and D blocks use (1, 7) and
(7, 1) kernels.  It takes 299x299 input.  ``device=None`` means the
current context (the GPU).
"""
from __future__ import annotations

from ....context import as_device
from ...block import HybridBlock
from ... import nn
from .alexnet import PRETRAINED
from .squeezenet import HybridConcurrent

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(device, **kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, device=device, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001, device=device))
    out.add(nn.Activation("relu"))
    return out


_SETTINGS = ("channels", "kernel_size", "strides", "padding")


def _make_branch(device, use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        kwargs = {k: v for k, v in zip(_SETTINGS, setting) if v is not None}
        out.add(_make_basic_conv(device, **kwargs))
    return out


def _make_A(pool_features, prefix, device):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(device, None, (64, 1, None, None)))
        out.add(_make_branch(device, None, (48, 1, None, None),
                             (64, 5, None, 2)))
        out.add(_make_branch(device, None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, None, 1)))
        out.add(_make_branch(device, "avg",
                             (pool_features, 1, None, None)))
    return out


def _make_B(prefix, device):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(device, None, (384, 3, 2, None)))
        out.add(_make_branch(device, None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, 2, None)))
        out.add(_make_branch(device, "max"))
    return out


def _make_C(channels_7x7, prefix, device):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(device, None, (192, 1, None, None)))
        out.add(_make_branch(device, None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(device, None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch(device, "avg", (192, 1, None, None)))
    return out


def _make_D(prefix, device):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(device, None, (192, 1, None, None),
                             (320, 3, 2, None)))
        out.add(_make_branch(device, None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch(device, "max"))
    return out


def _make_E(prefix, device):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(device, None, (320, 1, None, None)))

        branch_3x3 = nn.HybridSequential(prefix="")
        out.add(branch_3x3)
        branch_3x3.add(_make_branch(device, None, (384, 1, None, None)))
        branch_3x3_split = HybridConcurrent(axis=1, prefix="")
        branch_3x3_split.add(_make_branch(device, None,
                                          (384, (1, 3), None, (0, 1))))
        branch_3x3_split.add(_make_branch(device, None,
                                          (384, (3, 1), None, (1, 0))))
        branch_3x3.add(branch_3x3_split)

        branch_3x3dbl = nn.HybridSequential(prefix="")
        out.add(branch_3x3dbl)
        branch_3x3dbl.add(_make_branch(device, None, (448, 1, None, None),
                                       (384, 3, None, 1)))
        branch_3x3dbl_split = HybridConcurrent(axis=1, prefix="")
        branch_3x3dbl.add(branch_3x3dbl_split)
        branch_3x3dbl_split.add(_make_branch(device, None,
                                             (384, (1, 3), None, (0, 1))))
        branch_3x3dbl_split.add(_make_branch(device, None,
                                             (384, (3, 1), None, (1, 0))))

        out.add(_make_branch(device, "avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    """The stem, three A blocks, B, four C blocks, D, two E blocks, an 8x8
    average pool, dropout and the classifier."""

    def __init__(self, classes=1000, device=None, *, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            add = self.features.add
            add(_make_basic_conv(device, channels=32, kernel_size=3,
                                 strides=2))
            add(_make_basic_conv(device, channels=32, kernel_size=3))
            add(_make_basic_conv(device, channels=64, kernel_size=3,
                                 padding=1))
            add(nn.MaxPool2D(pool_size=3, strides=2))
            add(_make_basic_conv(device, channels=80, kernel_size=1))
            add(_make_basic_conv(device, channels=192, kernel_size=3))
            add(nn.MaxPool2D(pool_size=3, strides=2))
            add(_make_A(32, "A1_", device))
            add(_make_A(64, "A2_", device))
            add(_make_A(64, "A3_", device))
            add(_make_B("B_", device))
            add(_make_C(128, "C1_", device))
            add(_make_C(160, "C2_", device))
            add(_make_C(160, "C3_", device))
            add(_make_C(192, "C4_", device))
            add(_make_D("D_", device))
            add(_make_E("E1_", device))
            add(_make_E("E2_", device))
            add(nn.AvgPool2D(pool_size=8))
            add(nn.Dropout(0.5))
            self.output = nn.Dense(classes, device=device)

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root="~/.mxnet/models",
                 **kwargs):
    """Inception-v3, uninitialised (``pretrained=True`` raises)."""
    if pretrained:
        raise NotImplementedError(PRETRAINED)
    return Inception3(**kwargs)
