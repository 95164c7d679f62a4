"""Parameter initialisation (counterpart of ``mxnet_tpu/initializer.py``).

An :class:`Initializer` is called as ``init(desc, arr, generator=None)``:
``desc`` is the parameter's name (an :class:`InitDesc` carries the
symbol's attributes too), ``arr`` an NDArray or a tensor, written in place.
It dispatches on the name as MXNet's ``Initializer.__call__`` does: an
``__init__`` attribute names the initializer of that one parameter;
``bias``, ``beta``, the moving and running means, ``moving_inv_var``,
``moving_avg``, ``min`` and ``max`` are zero; ``gamma`` and the moving and
running variances one; ``weight`` and any other name take the
initializer's own draw, ``_init_weight``.  Random draws come from
``generator``, a ``torch.Generator`` on the array's device (torch's
default one for that device when ``None``), so the bits differ from the
JAX package's numpy draws; they are held to each other by distribution.

``create`` takes an instance, a registered name (``"xavier"``,
``"zeros"``) or the JSON of :meth:`Initializer.dumps`.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

__all__ = ["InitDesc", "Initializer", "register", "alias", "create", "Zero",
           "One", "Constant", "Uniform", "Normal", "Xavier", "MSRAPrelu"]

_REGISTRY = {}


def register(klass):
    """Register an initializer under its lower-cased class name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def alias(*names):
    def deco(klass):
        for n in names:
            _REGISTRY[n.lower()] = klass
        return register(klass)
    return deco


class InitDesc(str):
    """A parameter's name, with the symbol's ``attrs`` for it."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _tensor(arr):
    return arr if isinstance(arr, torch.Tensor) else arr._data


class Initializer:
    """Base class: dispatch by name (``mxnet_tpu/initializer.py:41-150``);
    subclasses define ``_init_weight(name, tensor, generator)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON (what ``create`` reads back)."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    @torch.no_grad()
    def __call__(self, desc, arr, generator=None):
        if not isinstance(desc, str):
            raise TypeError("first argument must be a parameter name "
                            "(InitDesc)")
        t = _tensor(arr)
        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(desc, t, generator)
            return
        name = str(desc)
        if name.startswith("upsampling"):
            self._init_bilinear(name, t, generator)
        elif name.startswith("stn_loc") and name.endswith("weight"):
            t.zero_()
        elif name.startswith("stn_loc") and name.endswith("bias"):
            self._init_loc_bias(name, t, generator)
        elif name.endswith(("bias", "beta", "moving_mean", "running_mean",
                            "moving_inv_var", "moving_avg", "min", "max")):
            t.zero_()
        elif name.endswith(("gamma", "moving_var", "running_var")):
            t.fill_(1.0)
        else:
            self._init_weight(name, t, generator)

    def _init_bilinear(self, name, t, generator):
        shape = t.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        t.copy_(torch.from_numpy(w.reshape(shape)))

    def _init_loc_bias(self, name, t, generator):
        if t.shape[0] != 6:
            raise ValueError(f"{name}: a spatial-transformer bias has 6 "
                             f"elements, got shape {tuple(t.shape)}")
        t.copy_(torch.tensor([1.0, 0, 0, 0, 1.0, 0]))

    def _init_weight(self, name, t, generator):
        raise NotImplementedError("subclass must implement _init_weight")

    def __eq__(self, other):
        return (self.__class__ is other.__class__
                and self._kwargs == other._kwargs)

    def __hash__(self):
        return hash(self.dumps())

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"


def create(init, **kwargs):
    """An initializer from an instance or callable (returned as they are),
    a registered name, or the JSON of ``dumps``."""
    if isinstance(init, Initializer) or callable(init):
        return init
    if isinstance(init, str):
        text = init.strip()
        if text.startswith("["):
            name, kw = json.loads(text)
            return _REGISTRY[name.lower()](**kw)
        if init.lower() not in _REGISTRY:
            raise ValueError(f"unknown initializer {init!r}")
        return _REGISTRY[init.lower()](**kwargs)
    raise TypeError(f"cannot create initializer from {init!r}")


@alias("zeros")
class Zero(Initializer):
    def _init_weight(self, name, t, generator):
        t.zero_()


@alias("ones")
class One(Initializer):
    def _init_weight(self, name, t, generator):
        t.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, t, generator):
        t.fill_(float(self.value))


@register
class Uniform(Initializer):
    """U(-scale, scale) for weights (MXNet's default, scale 0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, t, generator):
        t.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    """N(0, sigma) for weights."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, t, generator):
        t.normal_(0.0, self.sigma, generator=generator)


@register
class Xavier(Initializer):
    """Glorot's initialisation: scale ``sqrt(magnitude / factor)``, the
    factor the fan-in, fan-out or their mean (a convolution's fans count
    its kernel's elements); uniform in ``[-scale, scale]`` or gaussian with
    that deviation."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, t, generator):
        shape = tuple(t.shape)
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {shape} for "
                             f"{name}")
        hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        factors = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                   "out": fan_out}
        if self.factor_type not in factors:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factors[self.factor_type])
        if self.rnd_type == "uniform":
            t.uniform_(-scale, scale, generator=generator)
        elif self.rnd_type == "gaussian":
            t.normal_(0.0, scale, generator=generator)
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He's initialisation: gaussian Xavier with magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}
