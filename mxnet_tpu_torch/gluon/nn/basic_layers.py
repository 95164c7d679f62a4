"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``).

Each layer takes the JAX package's arguments in its order, with its
defaults (``mxnet_tpu/gluon/nn/basic_layers.py``), but for ``prefix`` and
``params``; ``dtype`` is a name (``"float32"``) or a ``torch.dtype``, and
``device`` (keyword only) is where the parameters are allocated at
construction.  ``HybridBlock.initialize`` fills them, with a layer's
``*_initializer`` for its own.  ``Dense(in_units=0)``,
``BatchNorm(in_channels=0)`` and ``LayerNorm(in_channels=0)`` defer their
shapes to the first forward or to ``load_parameters``, as Gluon does.
Each layer that the JAX package runs through an op on one of AMP's lists
(``FullyConnected``, ``LayerNorm``, ``BatchNorm``) passes its inputs
through AMP's policy (``ops.registry.amp_inputs``) first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ... import autograd
from ...base import torch_dtype
from ...ops import nn as ops
from ...ops.registry import amp_inputs
from ..block import HybridBlock, is_deferred

__all__ = ["HybridSequential", "Dense", "Dropout", "Embedding", "LayerNorm",
           "BatchNorm", "Flatten"]

def _param(shape, dtype, device, requires_grad=True):
    """A parameter of ``shape``, or a deferred one when a width is 0."""
    if 0 in shape:
        return nn.UninitializedParameter(requires_grad, device=device,
                                         dtype=dtype)
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad)


def _buffer(shape, dtype, device):
    if 0 in shape:
        return nn.UninitializedBuffer(device=device, dtype=dtype)
    return torch.empty(shape, dtype=dtype, device=device)


class HybridSequential(HybridBlock):
    """Stacks blocks; children are named ``0, 1, ...`` in the state dict."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """Fully-connected layer, weight ``(units, in_units)`` as MXNet (and
    ``nn.Linear``) store it; ``in_units=0`` defers it.  ``activation`` is
    any type of ``Activation`` (relu, sigmoid, tanh, softrelu, softsign),
    applied to the output as ``mxnet_tpu/gluon/nn/basic_layers.py:126-127``
    does."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, *, device=None):
        super().__init__()
        dtype = torch_dtype(dtype)
        self._units = units
        self._flatten = flatten
        self.weight = _param((units, in_units), dtype, device)
        self.bias = nn.Parameter(torch.empty(units, dtype=dtype,
                                             device=device)) \
            if use_bias else None
        self._param_inits = {"weight": weight_initializer,
                             "bias": bias_initializer}
        if activation is not None and activation not in ops._ACT:
            raise ValueError(f"unknown activation {activation!r}")
        self._act_type = activation

    def forward(self, x):
        if is_deferred(self.weight):
            in_units = math.prod(x.shape[1:]) if self._flatten \
                else x.shape[-1]
            self._materialize({"weight": (self._units, in_units)},
                              x.device)
        x, w, b = amp_inputs("FullyConnected", x, self.weight, self.bias)
        y = ops.fully_connected(x, w, b, self._flatten)
        return y if self._act_type is None else ops.activation(
            y, self._act_type)


class Dropout(HybridBlock):
    """Dropout; the identity unless ``autograd.is_training()``.  ``axes``
    shares the mask along those axes (the ``Dropout`` op's)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        if not autograd.is_training() or self._rate <= 0:
            return x
        if self._axes:
            return ops._dropout_op(x, self._rate, axes=self._axes,
                                   __training__=True)
        return F.dropout(x, self._rate, training=True)


class Embedding(HybridBlock):
    """Index -> vector lookup over a ``(input_dim, output_dim)`` table.
    ``sparse_grad`` is taken, and the gradient stays dense (sparse storage
    is ROADMAP.md queue 1 item 2.5)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, *,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            input_dim, output_dim, dtype=torch_dtype(dtype), device=device))
        self._param_inits = {"weight": weight_initializer}

    def forward(self, x):
        return ops.embedding(x, self.weight)


class LayerNorm(HybridBlock):
    """Layer normalisation over ``axis`` with learnable ``gamma``/``beta``;
    ``in_channels=0`` defers their width to the first forward.
    ``center=False`` keeps beta at its initial zero and ``scale=False``
    gamma at one; neither then takes a gradient
    (``mxnet_tpu/gluon/nn/basic_layers.py:330-352``)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, *, dtype=torch.float32, device=None):
        super().__init__()
        dtype = torch_dtype(dtype)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = _param((in_channels,), dtype, device,
                            requires_grad=scale)
        self.beta = _param((in_channels,), dtype, device,
                           requires_grad=center)
        self._param_inits = {"gamma": gamma_initializer,
                             "beta": beta_initializer}

    def forward(self, x):
        if is_deferred(self.gamma):
            c = (x.shape[self._axis],)
            self._materialize({"gamma": c, "beta": c}, x.device)
        x, gamma, beta = amp_inputs("LayerNorm", x, self.gamma, self.beta)
        return ops.layer_norm(x, gamma, beta, self._axis, self._epsilon)


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` with learnable ``gamma``/``beta``
    and the buffers ``running_mean``/``running_var``
    (``mxnet_tpu/gluon/nn/basic_layers.py:180``).  ``scale=False`` fixes
    gamma at one (the op's ``fix_gamma``) and ``center=False`` keeps beta at
    its initial zero; neither then takes a gradient.

    Under ``autograd.is_training()`` (``record()``, ``train_mode()``) and
    without ``use_global_stats`` it normalises with the batch statistics and
    moves the running ones towards them by ``momentum``; otherwise it uses
    the running statistics.  ``nn.Module.train()``/``eval()`` do not enter
    into it, as MXNet's op reads only the autograd flag."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        dtype = torch_dtype(dtype)
        self._param_inits = {"gamma": gamma_initializer,
                             "beta": beta_initializer,
                             "running_mean": running_mean_initializer,
                             "running_var": running_variance_initializer}
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._fix_gamma = not scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,)
        self.gamma = _param(shape, dtype, device, requires_grad=scale)
        self.beta = _param(shape, dtype, device, requires_grad=center)
        self.register_buffer("running_mean", _buffer(shape, dtype, device))
        self.register_buffer("running_var", _buffer(shape, dtype, device))

    @staticmethod
    def _param_dtype(dtype):
        """``cast("float16")`` keeps BatchNorm's parameters and statistics
        in fp32 (``mxnet_tpu/gluon/nn/basic_layers.py:225-228``)."""
        return torch.float32 if torch_dtype(dtype) is torch.float16 \
            else dtype

    def forward(self, x):
        if is_deferred(self.gamma):
            c = (x.shape[self._axis],)
            self._materialize({"gamma": c, "beta": c, "running_mean": c,
                               "running_var": c}, x.device)
        # the running statistics are auxiliary inputs: AMP never casts them
        x, gamma, beta = amp_inputs("BatchNorm", x, self.gamma, self.beta)
        args = (x, gamma, beta, self.running_mean, self.running_var,
                self._epsilon, self._fix_gamma, self._axis)
        if self._use_global_stats or not autograd.is_training():
            return ops.batch_norm(*args)
        out, mean, var = ops.batch_norm(*args, training=True)
        ops.update_moving_stats(self.running_mean, self.running_var, mean,
                                var, self._momentum)
        return out


class Flatten(HybridBlock):
    """``(N, ...) -> (N, prod(...))``."""

    def forward(self, x):
        return ops.flatten(x)
