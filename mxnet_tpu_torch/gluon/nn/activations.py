"""Activation blocks (counterpart of ``mxnet_tpu/gluon/nn/activations.py:
28-92``): ``Activation`` by name, and ``LeakyReLU``, ``PReLU``, ``ELU``,
``SELU``, ``Swish`` and ``GELU`` on the ``LeakyReLU`` op
(``ops/elemwise.py``).  Each runs a tensor ``forward`` and carries the
reference's ``hybrid_forward`` for ``export``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import initializer
from ...ops import elemwise
from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


class Activation(HybridBlock):
    """An activation by name: relu, sigmoid, tanh, softrelu, softsign.  Its
    alias, and so its default prefix, is the activation's name
    (``relu0_``)."""

    def __init__(self, activation, *, prefix=None, params=None):
        if activation not in ops._ACT:
            raise ValueError(f"unknown activation {activation!r}")
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return ops.activation(x, self._act_type)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha, *, prefix=None, params=None):
        if alpha < 0:
            raise AssertionError("Slope coefficient for LeakyReLU must be no "
                                 "less than 0.")
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return elemwise.leaky_relu(x, act_type="leaky", slope=self._alpha)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha,
                           name="fwd")

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of one element, 0.25 at
    first."""

    def __init__(self, alpha_initializer=None, *, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self._new_param("alpha", (1,), torch.float32,
                                         device, init=alpha_initializer)

    def forward(self, x):
        return elemwise.leaky_relu(x, self._parameters["alpha"],
                                   act_type="prelu")

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu", name="fwd")


class ELU(HybridBlock):
    """``x`` where positive, ``alpha * (exp(x) - 1)`` elsewhere."""

    def __init__(self, alpha=1.0, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return elemwise.leaky_relu(x, act_type="elu", slope=self._alpha)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """The scaled ELU of Klambauer et al."""

    def __init__(self, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        return elemwise.leaky_relu(x, act_type="selu")

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu", name="fwd")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x, name="fwd")


class GELU(HybridBlock):
    """x * Phi(x) in the exact erf form."""

    def __init__(self, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        return F.gelu(x, approximate="none")

    def hybrid_forward(self, F, x):
        return 0.5 * x * (1.0 + F.erf(x / (2.0 ** 0.5)))
