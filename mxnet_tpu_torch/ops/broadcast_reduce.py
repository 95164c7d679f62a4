"""Broadcasting binary ops and reductions (counterpart of
``mxnet_tpu/ops/broadcast_reduce.py``).

Reductions take MXNet's ``axis`` (None, an int or a tuple), ``keepdims`` and
``exclude`` (reduce over the complement of ``axis``).  Comparisons return
0/1 in the left operand's dtype.  ``argmax``/``argmin``/``argmax_channel``
return the index in the input's dtype, as the JAX package does (float32
for float32 data).  Integer sums stay in the input's dtype (torch would
widen them to int64).
"""
from __future__ import annotations

import ast

import torch

from ..base import parse_bool, parse_tuple, torch_dtype
from .registry import register


def _axes(axis, ndim, exclude=False):
    """Normalised reduce axes: a tuple, () for none; ``None`` for all."""
    if isinstance(axis, str):
        axis = ast.literal_eval(axis)
    if axis is None:
        return None if not parse_bool(exclude) else ()
    if isinstance(axis, int):
        axis = (axis,)
    for a in axis:
        if not -ndim <= a < ndim:
            raise ValueError(f"axis {a} out of range for a {ndim}-"
                             f"dimensional input")
    axis = tuple(a % ndim for a in axis)
    if parse_bool(exclude):
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _binary(name, tfn, cast_back=False):
    def fn(lhs, rhs):
        out = tfn(lhs, rhs)
        return out.to(lhs.dtype) if cast_back else out
    fn.__name__ = name
    register(name)(fn)
    return fn


_binary("broadcast_add", torch.add)
_binary("broadcast_plus", torch.add)
_binary("broadcast_sub", torch.sub)
_binary("broadcast_minus", torch.sub)
_binary("broadcast_mul", torch.mul)
_binary("broadcast_div", torch.true_divide)
_binary("broadcast_mod", torch.remainder)
_binary("broadcast_power", torch.pow)
# MXNet's tie rule (ge/le backward): the whole gradient to the left operand
_binary("broadcast_maximum", lambda a, b: torch.where(a >= b, a, b))
_binary("broadcast_minimum", lambda a, b: torch.where(a <= b, a, b))
_binary("broadcast_hypot", torch.hypot)
_binary("broadcast_equal", torch.eq, cast_back=True)
_binary("broadcast_not_equal", torch.ne, cast_back=True)
_binary("broadcast_greater", torch.gt, cast_back=True)
_binary("broadcast_greater_equal", torch.ge, cast_back=True)
_binary("broadcast_lesser", torch.lt, cast_back=True)
_binary("broadcast_lesser_equal", torch.le, cast_back=True)
_binary("broadcast_logical_and", lambda a, b: (a != 0) & (b != 0),
        cast_back=True)
_binary("broadcast_logical_or", lambda a, b: (a != 0) | (b != 0),
        cast_back=True)
_binary("broadcast_logical_xor", lambda a, b: (a != 0) ^ (b != 0),
        cast_back=True)


@register("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """``lhs`` broadcast to ``rhs``'s shape, or only its ``lhs_axes`` to
    the sizes of ``rhs``'s ``rhs_axes``."""
    if lhs_axes is None and rhs_axes is None:
        return lhs.expand(rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(parse_tuple(lhs_axes), parse_tuple(rhs_axes)):
        shape[la] = rhs.shape[ra]
    return lhs.expand(shape)


@register("broadcast_to")
def broadcast_to(x, shape=None):
    """0 in ``shape`` keeps that axis."""
    shape = parse_tuple(shape)
    return x.expand(tuple(s if s != 0 else x.shape[i]
                          for i, s in enumerate(shape)))


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(x, axis=None, size=None):
    shape = list(x.shape)
    for a, s in zip(parse_tuple(axis), parse_tuple(size)):
        shape[a] = s
    return x.expand(tuple(shape))


def _over(fn, data, ax, keepdims):
    """``fn(t, dim)`` over one axis at a time, for the reductions torch
    takes one axis to (``prod``)."""
    out = data
    for a in sorted(ax, reverse=True):
        out = fn(out, a, keepdim=keepdims)
    return out


def _sum(x, ax, keepdims):
    out = torch.sum(x, dim=ax, keepdim=keepdims)
    # MXNet keeps an integer sum's width; torch widens it to int64
    return out.to(x.dtype) if not x.is_floating_point() else out


def _mean(x, ax, keepdims):
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=ax, keepdim=keepdims)


def _nanprod(x, ax, keepdims):
    return _over(torch.prod, torch.where(torch.isnan(x), 1.0, x).to(x.dtype)
                 if x.is_floating_point() else x, ax, keepdims)


_REDUCERS = {
    "sum": _sum,
    "nansum": lambda x, ax, kd: torch.nansum(x, dim=ax, keepdim=kd),
    "mean": _mean,
    "prod": lambda x, ax, kd: _over(torch.prod, x, ax, kd),
    "nanprod": _nanprod,
    "max": lambda x, ax, kd: torch.amax(x, dim=ax, keepdim=kd),
    "min": lambda x, ax, kd: torch.amin(x, dim=ax, keepdim=kd),
}


def _reduce_call(name, data, axis, keepdims, exclude):
    ax = _axes(axis, data.dim(), exclude)
    if ax is None:
        ax = tuple(range(data.dim()))
    if not ax:
        # torch reads an empty dim list as "all axes"; MXNet as none
        return data.clone()
    return _REDUCERS[name](data, ax, parse_bool(keepdims))


def _reduce(name):
    def fn(data, axis=None, keepdims=False, exclude=False):
        return _reduce_call(name, data, axis, keepdims, exclude)
    fn.__name__ = name
    fn.__doc__ = f"Reduction {name}."
    register(name)(fn)
    return fn


for _name in _REDUCERS:
    _reduce(_name)


@register("sum_axis")
def sum_axis(data, axis=None, keepdims=False, exclude=False):
    return _reduce_call("sum", data, axis, keepdims, exclude)


@register("_square_sum")
def square_sum(data, axis=None, keepdims=False, exclude=False):
    """Sum of squares."""
    return _reduce_call("sum", torch.square(data), axis, keepdims, exclude)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False, out_dtype=None):
    """L1 or L2 norm."""
    ordv = int(ord) if ord is not None else 2
    src = torch.abs(data) if ordv == 1 else torch.square(data)
    out = _reduce_call("sum", src, axis, keepdims, False)
    if ordv != 1:
        out = torch.sqrt(out)
    if out_dtype is not None:
        out = out.to(torch_dtype(out_dtype))
    return out


def _arg_reduce(name, tfn):
    def fn(data, axis=None, keepdims=False):
        if axis is None:
            out = tfn(data.reshape(-1), dim=0)
            if parse_bool(keepdims):
                out = out.reshape((1,) * data.dim())
        else:
            out = tfn(data, dim=int(axis), keepdim=parse_bool(keepdims))
        return out.to(data.dtype)
    fn.__name__ = name
    register(name)(fn)
    return fn


_arg_reduce("argmax", torch.argmax)
_arg_reduce("argmin", torch.argmin)


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(data.dtype)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """One element along ``axis`` per position of ``index`` (clipped into
    range)."""
    ax = int(axis) % data.dim()
    idx = index.long().clamp(0, data.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if parse_bool(keepdims) else out.squeeze(ax)


@register("moments")
def moments(data, axes=None, keepdims=False):
    """Mean and biased variance over ``axes``."""
    ax = _axes(axes, data.dim())
    if ax is None:
        ax = tuple(range(data.dim()))
    kd = parse_bool(keepdims)
    mean = torch.mean(data, dim=ax, keepdim=kd)
    var = torch.var(data, dim=ax, keepdim=kd, unbiased=False)
    return mean, var

