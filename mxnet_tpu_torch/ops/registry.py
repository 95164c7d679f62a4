"""The op table behind ``mx.nd.*`` (the port's copy of
``mxnet_tpu/ops/registry.py``).

An op is a pure torch function ``fn(*tensors, **attrs)``; ``ndarray/
register.py`` makes the ``mx.nd`` functions from this table.  Gradients are
torch autograd's over that function: there are no registered backward ops,
as the JAX package has none (it takes ``jax.vjp``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

_OP_TABLE: Dict[str, "OpDef"] = {}

# AMP's cast policy (``contrib/amp/amp.py``): None while AMP is off, else
# ``policy(names, tensors) -> tensors``.  ``ndarray.invoke`` applies it to
# every op call, and the gluon layers, losses and models at each direct
# torch call where the JAX package dispatches a listed op; the Executor
# does not, as the JAX package's symbolic executor does not.
amp_policy = None


def amp_inputs(name, *tensors):
    """``tensors`` (None entries kept) as AMP casts the inputs of op
    ``name``; unchanged while AMP is off."""
    if amp_policy is None:
        return tensors
    return amp_policy((name,), tensors)


class OpDef:
    """A registered op: canonical ``name``, the function ``fn``, its
    ``aliases``; ``wrap_list`` ops take a variable number of arrays as
    their leading inputs (``concat``, ``add_n``)."""

    __slots__ = ("name", "fn", "aliases", "wrap_list", "num_inputs", "doc")

    def __init__(self, name, fn, aliases=(), wrap_list=False, num_inputs=None):
        self.name = name
        self.fn = fn
        self.aliases = tuple(aliases)
        self.wrap_list = wrap_list
        self.num_inputs = num_inputs
        self.doc = fn.__doc__

    def __repr__(self):
        return f"OpDef({self.name})"


def register(name: str, aliases=(), wrap_list: bool = False, num_inputs=None):
    """Decorator: register a pure torch function as an op."""

    def deco(fn: Callable):
        op = OpDef(name, fn, aliases=aliases, wrap_list=wrap_list,
                   num_inputs=num_inputs)
        _OP_TABLE[name] = op
        for a in aliases:
            _OP_TABLE[a] = op
        return fn

    return deco


def get(name: str) -> Optional[OpDef]:
    return _OP_TABLE.get(name)


def require(name: str) -> OpDef:
    op = _OP_TABLE.get(name)
    if op is None:
        raise KeyError(f"operator {name!r} is not registered")
    return op


def list_ops():
    """Canonical op names, each once."""
    seen, out = set(), []
    for op in _OP_TABLE.values():
        if id(op) not in seen:
            seen.add(id(op))
            out.append(op.name)
    return out


def all_names():
    return list(_OP_TABLE)
