"""``mx.sym``: the Symbol and one function per name in the port's op table
(counterpart of ``mxnet_tpu/symbol/__init__.py``), with the ``random``,
``linalg``, ``contrib`` and ``image`` sub-namespaces limited to the names
the port's table has.  ``contrib.foreach``/``while_loop``/``cond`` are not
ported (ROADMAP.md, queue 1 item 7).
"""
import math as _math
import sys as _sys
import types as _types

from .symbol import (  # noqa: F401
    Group, Symbol, Variable, load, load_json, make_sym_func, var,
)
from ..ops import registry as _reg

_CURRENT = _sys.modules[__name__]
for _name in _reg.all_names():
    if not hasattr(_CURRENT, _name):
        setattr(_CURRENT, _name, make_sym_func(_reg.get(_name)))


def _facade(name, prefixes):
    mod = _types.ModuleType(f"{__name__}.{name}")
    for opname in _reg.all_names():
        for p in prefixes:
            short = opname[len(p):] if opname.startswith(p) else ""
            if short and not hasattr(mod, short):
                setattr(mod, short, make_sym_func(_reg.get(opname)))
    return mod


random = _facade("random", ("_random_", "_sample_"))
linalg = _facade("linalg", ("_linalg_",))
contrib = _facade("contrib", ("_contrib_",))
image = _facade("image", ("_image_",))
del _name


def zeros(shape, dtype=None, **kwargs):
    return _zeros(shape=shape, dtype=dtype or "float32")  # noqa: F821


def ones(shape, dtype=None, **kwargs):
    return _ones(shape=shape, dtype=dtype or "float32")  # noqa: F821


def _elementwise(pair, scalar, rscalar, plain):
    """An MXNet binary function of Symbols and scalars: the broadcast op
    for two Symbols, the scalar ops otherwise, ``plain`` for two
    numbers."""
    def f(left, right):
        if isinstance(left, Symbol) and isinstance(right, Symbol):
            return getattr(_CURRENT, pair)(left, right)
        if isinstance(left, Symbol):
            return getattr(_CURRENT, scalar)(left, scalar=float(right))
        if isinstance(right, Symbol):
            return getattr(_CURRENT, rscalar)(right, scalar=float(left))
        return plain(left, right)
    return f


maximum = _elementwise("_maximum", "_maximum_scalar", "_maximum_scalar", max)
minimum = _elementwise("_minimum", "_minimum_scalar", "_minimum_scalar", min)
pow = _elementwise("_power", "_power_scalar", "_rpower_scalar",
                   lambda a, b: a ** b)
power = pow
hypot = _elementwise("_hypot", "_hypot_scalar", "_hypot_scalar",
                     _math.hypot)


def arange(start, stop=None, step=1.0, repeat=1, infer_range=False,
           name=None, dtype="float32"):
    return _arange(start=float(start),  # noqa: F821
                   stop=float(stop) if stop is not None else None,
                   step=float(step), repeat=int(repeat),
                   infer_range=infer_range, dtype=dtype, name=name)


def linspace(start, stop, num, endpoint=True, name=None, dtype="float32"):
    return _linspace(start=float(start), stop=float(stop),  # noqa: F821
                     num=int(num), endpoint=endpoint, dtype=dtype, name=name)
