"""Parameter initialisation (counterpart of ``mxnet_tpu/initializer.py``).

Only the default that ``Block.initialize`` uses is ported: ``Uniform``,
dispatched by parameter name as MXNet's ``Initializer.__call__`` does
(``bias``/``beta`` and ``running_mean`` zero, ``gamma`` and ``running_var``
one, everything else uniform), drawn from an explicit ``torch.Generator``
on the tensor's device.
"""
from __future__ import annotations

import torch

__all__ = ["Uniform"]


class Uniform:
    """U(-scale, scale) for weights (MXNet's default, scale 0.07)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    @torch.no_grad()
    def __call__(self, name, tensor, generator=None):
        if name.endswith(("bias", "beta", "running_mean")):
            tensor.zero_()
        elif name.endswith(("gamma", "running_var")):
            tensor.fill_(1.0)
        else:
            tensor.uniform_(-self.scale, self.scale, generator=generator)
