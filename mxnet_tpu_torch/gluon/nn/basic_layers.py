"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``).

Each layer takes the JAX package's arguments in its order, with its
defaults; ``prefix`` and ``params`` (keyword only) name it and share
parameters as in MXNet, ``dtype`` is a name (``"float32"``) or a
``torch.dtype``, and ``device`` (keyword only) is where the parameters are
allocated at construction (without it they are placed by ``initialize``,
``gluon/parameter.py``).  Each parameter attribute (``self.weight``) is
its Gluon ``Parameter``, under the prefixed name (``dense0_weight``), as in
MXNet; its tensor is registered with torch under the attribute's name,
and ``forward`` reads it there (``self._parameters["weight"]``).
``initialize`` fills it, with a layer's ``*_initializer`` for its own.
``Dense(in_units=0)``, ``BatchNorm(in_channels=0)``,
``LayerNorm(in_channels=0)`` and ``InstanceNorm(in_channels=0)`` defer
their shapes to the first forward or to ``load_parameters``, as Gluon
does.

Each layer runs a tensor ``forward`` eagerly and carries the reference's
``hybrid_forward`` (``F.FullyConnected``, ``F.BatchNorm``...), which
``export`` traces with ``F = mx.sym``.  Each layer that the JAX package
runs through an op on one of AMP's lists (``FullyConnected``,
``LayerNorm``, ``BatchNorm``) passes its inputs through AMP's policy
(``ops.registry.amp_inputs``) first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ... import autograd
from ... import ndarray as _nd
from ...base import torch_dtype
from ...ops import nn as ops
from ...ops.registry import amp_inputs
from ..block import Block, HybridBlock, is_deferred

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Embedding", "LayerNorm", "BatchNorm", "InstanceNorm", "Flatten",
           "Lambda", "HybridLambda"]


class _SequentialMixin:
    """``add``, indexing, ``len`` and iteration over the children."""

    def add(self, *blocks):
        """Append blocks, named ``0, 1, ...``."""
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_SequentialMixin, Block):
    """Stacks blocks (``mxnet_tpu/gluon/nn/basic_layers.py:18``); its
    children take what it is given (NDArrays stay NDArrays)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_SequentialMixin, HybridBlock):
    """Stacks hybrid blocks; children are named ``0, 1, ...`` in the state
    dict."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer, weight ``(units, in_units)`` as MXNet (and
    ``nn.Linear``) store it; ``in_units=0`` defers it.  ``activation`` is
    any type of ``Activation`` (relu, sigmoid, tanh, softrelu, softsign),
    applied to the output as ``mxnet_tpu/gluon/nn/basic_layers.py:126-127``
    does."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, *, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        dtype = torch_dtype(dtype)
        self._units = units
        self._flatten = flatten
        if activation is not None and activation not in ops._ACT:
            raise ValueError(f"unknown activation {activation!r}")
        self._act_type = activation
        self.weight = self._new_param("weight", (units, in_units), dtype,
                                      device, init=weight_initializer)
        self.bias = self._new_param("bias", (units,), dtype, device,
                                    init=bias_initializer) \
            if use_bias else None

    def forward(self, x):
        w = self._parameters["weight"]
        if is_deferred(w):
            in_units = math.prod(x.shape[1:]) if self._flatten \
                else x.shape[-1]
            self.weight._finish_deferred_init((self._units, in_units),
                                              x.device)
        x, w, b = amp_inputs("FullyConnected", x, w,
                             self._parameters.get("bias"))
        y = ops.fully_connected(x, w, b, self._flatten)
        return y if self._act_type is None else ops.activation(
            y, self._act_type)

    def hybrid_forward(self, F, x, weight, bias=None):
        args = (x, weight) if bias is None else (x, weight, bias)
        y = F.FullyConnected(*args, no_bias=bias is None,
                             num_hidden=self._units, flatten=self._flatten,
                             name="fwd")
        return y if self._act_type is None else F.Activation(
            y, act_type=self._act_type)

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape[1] else None} -> {shape[0]}, "
                f"{'linear' if self._act_type is None else self._act_type})")


class Dropout(HybridBlock):
    """Dropout; the identity unless ``autograd.is_training()``.  ``axes``
    shares the mask along those axes (the ``Dropout`` op's)."""

    def __init__(self, rate, axes=(), *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        if not autograd.is_training() or self._rate <= 0:
            return x
        if self._axes:
            return ops._dropout_op(x, self._rate, axes=self._axes,
                                   __training__=True)
        return F.dropout(x, self._rate, training=True)

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd")
        return F._copy(x)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class Embedding(HybridBlock):
    """Index -> vector lookup over a ``(input_dim, output_dim)`` table.
    ``sparse_grad`` is taken, and the gradient stays dense (sparse storage
    is ROADMAP.md queue 1 item 2.5)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, *,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim, self._output_dim = input_dim, output_dim
        self._dtype_name = str(dtype)
        self.weight = self._new_param("weight", (input_dim, output_dim),
                                      torch_dtype(dtype), device,
                                      init=weight_initializer)

    def forward(self, x):
        return ops.embedding(x, self._parameters["weight"])

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim, name="fwd")

    def __repr__(self):
        return (f"Embedding({self._input_dim} -> {self._output_dim}, "
                f"{self._dtype_name})")


class _Norm(HybridBlock):
    """gamma and beta over one axis; ``center=False`` keeps beta at its
    initial zero and ``scale=False`` gamma at one, neither then taking a
    gradient."""

    def _norm_params(self, in_channels, center, scale, gamma_initializer,
                     beta_initializer, dtype, device):
        shape = (in_channels,)
        self.gamma = self._new_param(
            "gamma", shape, dtype, device, init=gamma_initializer,
            grad_req="write" if scale else "null", differentiable=scale)
        self.beta = self._new_param(
            "beta", shape, dtype, device, init=beta_initializer,
            grad_req="write" if center else "null", differentiable=center)

    def _materialize(self, names, channels, device):
        for name in names:
            getattr(self, name)._finish_deferred_init((channels,), device)

    def __repr__(self):
        content = ", ".join(f"{k}={v!r}" for k, v in self._kwargs.items())
        c = self.gamma.shape[0]
        return f"{type(self).__name__}({content}, in_channels={c or None})"


class LayerNorm(_Norm):
    """Layer normalisation over ``axis`` with learnable ``gamma``/``beta``;
    ``in_channels=0`` defers their width to the first forward
    (``mxnet_tpu/gluon/nn/basic_layers.py:330-352``)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, *, prefix=None, params=None,
                 dtype=torch.float32, device=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        self._kwargs = {"eps": epsilon, "axis": axis, "center": center,
                        "scale": scale}
        self._norm_params(in_channels, center, scale, gamma_initializer,
                          beta_initializer, torch_dtype(dtype), device)

    def forward(self, x):
        params = self._parameters
        if is_deferred(params["gamma"]):
            self._materialize(("gamma", "beta"), x.shape[self._axis],
                              x.device)
        x, gamma, beta = amp_inputs("LayerNorm", x, params["gamma"],
                                    params["beta"])
        return ops.layer_norm(x, gamma, beta, self._axis, self._epsilon)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma=gamma, beta=beta, axis=self._axis,
                           eps=self._epsilon)


class InstanceNorm(_Norm):
    """Instance normalisation: each sample's channels normalised over their
    spatial axes (``mxnet_tpu/gluon/nn/basic_layers.py:283``), then
    ``gamma``/``beta`` on ``axis``; ``scale`` is off by default, as
    there."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, *, prefix=None, params=None,
                 dtype=torch.float32, device=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        self._kwargs = {"eps": epsilon, "axis": axis, "center": center,
                        "scale": scale}
        self._norm_params(in_channels, center, scale, gamma_initializer,
                          beta_initializer, torch_dtype(dtype), device)

    def forward(self, x):
        params = self._parameters
        if is_deferred(params["gamma"]):
            self._materialize(("gamma", "beta"), x.shape[self._axis],
                              x.device)
        gamma, beta = params["gamma"], params["beta"]
        if self._axis == 1:
            return ops.instance_norm(x, gamma, beta, self._epsilon)
        x = x.transpose(1, self._axis)
        return ops.instance_norm(x, gamma, beta,
                                 self._epsilon).transpose(1, self._axis)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon,
                                  name="fwd")
        x = F.swapaxes(x, dim1=1, dim2=self._axis)
        return F.swapaxes(F.InstanceNorm(x, gamma, beta, eps=self._epsilon,
                                         name="fwd"),
                          dim1=1, dim2=self._axis)


class BatchNorm(_Norm):
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
                 prefix=None, params=None, dtype=torch.float32,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        dtype = torch_dtype(dtype)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._fix_gamma = not scale
        self._use_global_stats = use_global_stats
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._norm_params(in_channels, center, scale, gamma_initializer,
                          beta_initializer, dtype, device)
        shape = (in_channels,)
        self.running_mean = self._new_param(
            "running_mean", shape, dtype, device,
            init=running_mean_initializer, grad_req="null",
            differentiable=False, buffer=True)
        self.running_var = self._new_param(
            "running_var", shape, dtype, device,
            init=running_variance_initializer, grad_req="null",
            differentiable=False, buffer=True)

    @staticmethod
    def _param_dtype(dtype):
        """``cast("float16")`` keeps BatchNorm's parameters and statistics
        in fp32 (``mxnet_tpu/gluon/nn/basic_layers.py:225-228``)."""
        return torch.float32 if torch_dtype(dtype) is torch.float16 \
            else dtype

    def forward(self, x):
        params, buffers = self._parameters, self._buffers
        if is_deferred(params["gamma"]):
            self._materialize(("gamma", "beta", "running_mean",
                               "running_var"), x.shape[self._axis],
                              x.device)
        # the running statistics are auxiliary inputs: AMP never casts them
        x, gamma, beta = amp_inputs("BatchNorm", x, params["gamma"],
                                    params["beta"])
        mean_run, var_run = buffers["running_mean"], buffers["running_var"]
        args = (x, gamma, beta, mean_run, var_run, self._epsilon,
                self._fix_gamma, self._axis)
        if self._use_global_stats or not autograd.is_training():
            return ops.batch_norm(*args)
        out, mean, var = ops.batch_norm(*args, training=True)
        ops.update_moving_stats(mean_run, var_run, mean, var,
                                self._momentum)
        return out

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)


class Flatten(HybridBlock):
    """``(N, ...) -> (N, prod(...))``."""

    def __init__(self, *, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        return ops.flatten(x)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """A function, or the name of an ``mx.nd`` function, as a block
    (``mxnet_tpu/gluon/nn/basic_layers.py:374``); it takes what it is
    given (NDArrays stay NDArrays)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            if not hasattr(_nd, function):
                raise AssertionError(f"Function name {function} is not "
                                     f"found in ndarray.")
            self._func_impl = getattr(_nd, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError(f"Unrecognized function in lambda: {function} "
                             f"of type {type(function)}")
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    """A function ``f(F, x, *args)``, or the name of an op in both ``mx.nd``
    and ``mx.sym``, as a hybrid block
    (``mxnet_tpu/gluon/nn/basic_layers.py:400``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        from ... import symbol as _sym
        if isinstance(function, str):
            if not (hasattr(_nd, function) and hasattr(_sym, function)):
                raise AssertionError(f"Function name {function} is not "
                                     f"found in symbol/ndarray.")
            funcs = {_nd: getattr(_nd, function),
                     _sym: getattr(_sym, function)}
            self._func = lambda F, *args: funcs[F](*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError(f"Unrecognized function in lambda: {function} "
                             f"of type {type(function)}")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"
