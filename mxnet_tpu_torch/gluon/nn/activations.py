"""Activation blocks (counterpart of ``mxnet_tpu/gluon/nn/activations.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ["Activation", "GELU"]


class Activation(HybridBlock):
    """An activation by name: relu, sigmoid, tanh, softrelu, softsign."""

    def __init__(self, activation):
        super().__init__()
        if activation not in ops._ACT:
            raise ValueError(f"unknown activation {activation!r}")
        self._act_type = activation

    def forward(self, x):
        return ops.activation(x, self._act_type)


class GELU(HybridBlock):
    """x * Phi(x) in the exact erf form."""

    def forward(self, x):
        return F.gelu(x, approximate="none")
