"""Make the ``mx.nd`` functions from the op table (the port's counterpart of
``mxnet_tpu/ndarray/register.py``).

Each generated function takes MXNet's calling conventions and runs the
op through ``ndarray.invoke``:
- leading positional arrays are the inputs, and further required inputs may
  come by keyword (``nd.LayerNorm(x, gamma=g, beta=b)``); later positional
  values fill the attributes in the op's order (``nd.one_hot(x, 3)``);
- ``ctx=``: an op that makes its output from no input array (``_zeros``,
  ``_arange``, the ``_random_*`` samplers) makes it on ``ctx``, or on
  the current context; an op with inputs runs on their device.  Nothing
  is moved afterwards.  Numpy inputs are made arrays on that device;
- ``out=`` receives the result (``ndarray._write``);
- mode-dependent ops (``Dropout``, ``BatchNorm``) get ``__training__``
  from ``autograd.is_training()``;
- stochastic ops get ``generator=``, their device's generator
  (``mx.random``);
- the update ops (``sgd_update`` ...) write their weight and states in
  place and return the weight; ``BatchNorm`` in training folds its batch
  statistics into the moving ones in place (``momentum``), and returns
  ``(out, mean, var)`` only with ``output_mean_var``.

The JAX package's Symbol delegation is not ported (no ``mx.sym`` yet).
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from .. import autograd
from .. import random as _rnd
from ..base import parse_bool, parse_float
from ..context import as_device
from ..ops import registry as _reg
from ..ops.nn import update_moving_stats
from ..ops.optimizer_ops import INPLACE_UPDATES
from ..ops.random_ops import STOCHASTIC_OPS
from .ndarray import NDArray, _as_nd, _write, invoke

MODE_DEPENDENT = {"Dropout", "BatchNorm"}
_STOCHASTIC = STOCHASTIC_OPS | {"Dropout"}
_ARRAY_TYPES = (NDArray, np.ndarray, torch.Tensor)
_FRONTEND_ATTRS = ("__training__", "generator")


def _signature(op):
    """(required input names, attribute names in order, takes *inputs,
    takes ctx)."""
    inputs, attrs, var = [], [], False
    params = inspect.signature(op.fn).parameters
    for p in params.values():
        if p.kind is inspect.Parameter.VAR_POSITIONAL:
            var = True
        elif p.kind is inspect.Parameter.VAR_KEYWORD \
                or p.name in _FRONTEND_ATTRS:
            continue
        elif p.default is inspect.Parameter.empty:
            inputs.append(p.name)
        else:
            attrs.append(p.name)
    return inputs, attrs, var, "ctx" in params


def _batch_norm_writeback(nd_inputs, outs, attrs):
    if attrs["__training__"] and \
            not parse_bool(attrs.get("use_global_stats", False)):
        update_moving_stats(nd_inputs[3]._data, nd_inputs[4]._data,
                            outs[1]._data, outs[2]._data,
                            parse_float(attrs.get("momentum", 0.9), 0.9))


def make_op_func(op):
    name = op.name
    stochastic = name in _STOCHASTIC
    mode_dep = name in MODE_DEPENDENT
    update = name in INPLACE_UPDATES
    is_bn = name == "BatchNorm"
    input_names, attr_names, var_inputs, creates = _signature(op)

    def fn(*args, out=None, name=None, ctx=None, **kwargs):
        i, nd_inputs = 0, []
        while i < len(args) and isinstance(args[i], _ARRAY_TYPES):
            nd_inputs.append(args[i])
            i += 1
        for pname in input_names[len(nd_inputs):]:
            if not isinstance(kwargs.get(pname), _ARRAY_TYPES):
                break
            nd_inputs.append(kwargs.pop(pname))
        if var_inputs:
            # optional inputs after the required ones (bias, gamma)
            nd_inputs += [kwargs.pop(k) for k in list(kwargs)
                          if isinstance(kwargs[k], _ARRAY_TYPES)]
        attrs = dict(kwargs)
        for v, pname in zip(args[i:], attr_names):
            attrs.setdefault(pname, v)
        device = next((x._data.device if isinstance(x, NDArray) else x.device
                       for x in nd_inputs
                       if isinstance(x, (NDArray, torch.Tensor))), None)
        if device is None:
            device = as_device(ctx if ctx is not None else attrs.get("ctx"))
        nd_inputs = [_as_nd(x, ctx=device) for x in nd_inputs]
        if creates and not nd_inputs:
            attrs["ctx"] = device
        if mode_dep:
            attrs["__training__"] = autograd.is_training()
        if stochastic:
            attrs["generator"] = _rnd.generator(device)
        if update:
            op.fn(*(x._data for x in nd_inputs), **attrs)
            result = nd_inputs[0]
            if out is not None and out is not result:
                _write(out, result._data.clone())
                result = out
            return result
        if not is_bn:
            return invoke(op, nd_inputs, attrs, out=out)
        outs = invoke(op, nd_inputs, attrs)
        _batch_norm_writeback(nd_inputs, outs, attrs)
        if parse_bool(attrs.get("output_mean_var", False)):
            return outs
        if out is not None:
            _write(out, outs[0]._data)
            return out
        return outs[0]

    fn.__name__ = name
    fn.__doc__ = op.doc or f"Operator {name} (see mxnet_tpu_torch/ops)."
    return fn


def populate(module):
    """Install a function for every name in the op table into ``module``
    (MXNet's ``_init_op_module``)."""
    installed = {}
    for opname in _reg.all_names():
        f = make_op_func(_reg.get(opname))
        f.__name__ = opname
        setattr(module, opname, f)
        installed[opname] = f
    return installed
