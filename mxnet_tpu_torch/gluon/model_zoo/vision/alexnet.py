"""AlexNet (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``;
Krizhevsky et al. 2012, the one-tower variant).

The JAX net's blocks in its order and scopes, so ``collect_params()`` gives
its names (``alexnet0_conv0_weight``) and its ``save_parameters`` file
loads here as it is.  The two ``Dense(4096)`` layers defer their input
width to the first forward or to ``load_parameters``.  ``device=None``
means the current context (the GPU).
"""
from __future__ import annotations

from ....context import as_device
from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]

PRETRAINED = ("pretrained weights are not downloaded; use load_parameters "
              "with a local file")


class AlexNet(HybridBlock):
    """Five convolutions with max pooling, then three fully-connected
    layers with dropout."""

    def __init__(self, classes=1000, device=None, *, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        device = as_device(device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                add = self.features.add
                add(nn.Conv2D(64, kernel_size=11, strides=4, padding=2,
                              activation="relu", device=device))
                add(nn.MaxPool2D(pool_size=3, strides=2))
                add(nn.Conv2D(192, kernel_size=5, padding=2,
                              activation="relu", device=device))
                add(nn.MaxPool2D(pool_size=3, strides=2))
                add(nn.Conv2D(384, kernel_size=3, padding=1,
                              activation="relu", device=device))
                add(nn.Conv2D(256, kernel_size=3, padding=1,
                              activation="relu", device=device))
                add(nn.Conv2D(256, kernel_size=3, padding=1,
                              activation="relu", device=device))
                add(nn.MaxPool2D(pool_size=3, strides=2))
                add(nn.Flatten())
                add(nn.Dense(4096, activation="relu", device=device))
                add(nn.Dropout(0.5))
                add(nn.Dense(4096, activation="relu", device=device))
                add(nn.Dropout(0.5))
            self.output = nn.Dense(classes, device=device)

    def forward(self, x):
        return self.output(self.features(x))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root="~/.mxnet/models", **kwargs):
    """AlexNet, uninitialised; ``ctx`` and ``root`` are where pretrained
    weights would load from and to (``pretrained=True`` raises)."""
    if pretrained:
        raise NotImplementedError(PRETRAINED)
    return AlexNet(**kwargs)
