"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (counterpart of
``mxnet_tpu/gluon/parameter.py:28-589``).

A ``Parameter`` is a named tensor with the settings a ``Trainer`` reads:
``grad_req`` (``'write'``, ``'add'`` or ``'null'``), ``lr_mult`` and
``wd_mult``.  Its name is the prefixed one Gluon gives
(``resnetv10_conv0_weight``, ``gluon/block.py``).  The tensor is an
``nn.Parameter`` (a buffer for one that takes no gradient by nature: the
running statistics, a ``Constant``) registered on the block that holds it,
which is what torch sees; the ``Parameter`` holds the same tensor object.
One ``Parameter`` per tensor: a block makes it when the tensor is made (or
when ``collect_params`` first meets a tensor registered by plain torch
code) and keeps it, so settings made through one ``collect_params()`` hold
in the next.  A block's tensor is held by the block; its ``Parameter``
holds it weakly, so the two make no reference cycle and dropping a block
and its Trainer frees their memory at once, without the cyclic
collector.  A ``Parameter`` whose block is gone raises on use.  A
standalone ``Parameter`` owns the tensor :meth:`Parameter.initialize`
makes.

``data()`` and ``grad()`` return NDArrays over the tensor and its gradient
buffer (no copy, as MXNet's do); the port's own code reads the tensors
with :meth:`Parameter.tensor` and :meth:`Parameter.grad_tensor`.  A width
unknown at construction (``in_units=0``) leaves an uninitialised tensor,
Gluon's ``allow_deferred_init``: its shape comes from the first forward
(on the input's device) or from a file, and it is filled then with the
initializer of the last ``initialize()``.  A tensor that ``initialize``
filled or a file loaded counts as initialised: a later ``initialize()``
keeps it, with MXNet's warning, unless ``force_reinit=True``
(``mxnet_tpu/gluon/parameter.py:127-131``).

Devices.  A layer given ``device=`` allocates there.  Without one, its
tensors wait on the CPU, unplaced, and ``initialize()`` or
``load_parameters()`` puts them on ``ctx``, or on the current context
(the GPU unless the caller runs under ``with mx.cpu():``), as MXNet
places them at ``initialize``.
"""
from __future__ import annotations

import re
import warnings
import weakref
from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedTensorMixin

from .. import autograd
from ..base import dtype_of, torch_dtype
from ..context import Context, as_device, current_context
from ..initializer import Initializer, Uniform, create
from ..ndarray import serialization
from ..ndarray.ndarray import NDArray, array

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "is_deferred", "tensor_of"]

# attribute set on a tensor that ``initialize`` filled or a file loaded
_INITIALIZED = "_mx_initialized"


class DeferredInitializationError(RuntimeError):
    """A parameter's shape is not known yet (``parameter.py:40``)."""


def is_deferred(t):
    """True for a parameter or buffer whose shape is not known yet."""
    return isinstance(t, UninitializedTensorMixin)


def tensor_of(x):
    """The tensor of an NDArray, a tensor as it is."""
    return x._data if isinstance(x, NDArray) else x


def _is_unknown(shape):
    return shape is None or any(s in (0, None, -1) for s in shape)


def _merge_shape(old, new):
    """``new`` with the dimensions it leaves unknown (0) taken from ``old``;
    raises where the two disagree."""
    if old is None or len(old) != len(new):
        if old is not None and not _is_unknown(old):
            raise ValueError(f"shape {tuple(new)} is incompatible with "
                             f"{tuple(old)}")
        return tuple(new)
    out = []
    for a, b in zip(old, new):
        if a not in (0, None) and b not in (0, None) and a != b:
            raise ValueError(f"shape {tuple(new)} is incompatible with "
                             f"{tuple(old)}")
        out.append(b if b not in (0, None) else a)
    return tuple(out)


def _fill(name, t, init, own, generator):
    """Fill ``t`` with the parameter's own initializer ``own`` if it has
    one, else with ``init`` dispatching on ``name``; the per-parameter one
    skips the name rules, as Gluon's does
    (``mxnet_tpu/gluon/parameter.py:161-171``)."""
    if own is None:
        init(name, t.data, generator)
    else:
        own = create(own)
        if isinstance(own, Initializer):
            with torch.no_grad():
                own._init_weight(name, t.data, generator)
        else:
            own(name, t.data, generator)
    setattr(t, _INITIALIZED, True)


class Parameter:
    """A named tensor with Gluon's gradient and optimizer settings
    (``mxnet_tpu/gluon/parameter.py:37``).  ``dtype`` is a name, a numpy or
    a torch dtype; ``shape`` may hold 0 for a width that is not known yet
    (with ``allow_deferred_init``)."""

    def __init__(self, name, grad_req="write", shape=None,
                 dtype=torch.float32, lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._shape = (shape,) if isinstance(shape, int) else \
            (tuple(shape) if shape is not None else None)
        self._dtype = torch_dtype(dtype)
        self._allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        for kind, v in (("stype", stype), ("grad_stype", grad_stype)):
            if v not in ("default", "row_sparse", "csr"):
                raise ValueError(f"invalid {kind} {v}: must be default, "
                                 f"row_sparse or csr")
        self._stype, self._grad_stype = stype, grad_stype
        autograd._check_grad_req(grad_req)
        self._grad_req = grad_req if differentiable else "null"
        self._owned = None           # the tensor of a standalone parameter
        self._ref = None             # a weak reference to a block's tensor
        self._unplaced = False       # allocated on the CPU, not placed yet
        self._deferred_init = None   # (init, generator) until a shape comes
        self._var = None

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    @property
    def _data(self):
        """The tensor; ``None`` before there is one.  Raises when the block
        that held it is gone."""
        if self._ref is None:
            return self._owned
        t = self._ref()
        if t is None:
            raise RuntimeError(f"Parameter {self.name!r} belongs to a block "
                               f"that has been freed; collect_params() of a "
                               f"live block gives its parameters")
        return t

    @_data.setter
    def _data(self, t):
        self._owned, self._ref = t, None

    def _bind(self, t):
        """Hold ``t``, a block's registered tensor, weakly: the block owns
        it."""
        self._owned, self._ref = None, weakref.ref(t)

    # ------------------------------------------------------------ properties
    @property
    def grad_req(self):
        t = self._data
        if t is None or is_deferred(t):
            return self._grad_req
        return autograd.grad_req_of(t)

    @grad_req.setter
    def grad_req(self, req):
        autograd._check_grad_req(req)
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        t = self._data
        if t is not None and not is_deferred(t):
            autograd._set_grad_req(t, req)
            if req == "null":
                t.grad = None

    def _apply_grad_req(self):
        """The stored ``grad_req`` on a tensor that just got its shape."""
        t = self._data
        if isinstance(t, nn.Parameter) or self._grad_req != "null":
            autograd._set_grad_req(t, self._grad_req)

    @property
    def shape(self):
        t = self._data
        if t is not None and not is_deferred(t):
            return tuple(t.shape)
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        self._shape = _merge_shape(self._shape, new_shape)

    @property
    def dtype(self):
        t = self._data
        return dtype_of(self._dtype if t is None or is_deferred(t)
                        else t.dtype)

    @dtype.setter
    def dtype(self, dtype):
        self.cast(dtype)

    @property
    def stype(self):
        return self._stype

    @property
    def grad_stype(self):
        return self._grad_stype

    # ---------------------------------------------------------------- tensor
    def _make_tensor(self, device=None, buffer=False):
        """The tensor a block registers for this parameter: an
        ``nn.Parameter`` (a buffer when ``buffer``), uninitialised while
        the shape is unknown.  Without ``device`` it waits on the CPU,
        unplaced (see the module docstring)."""
        req = self._grad_req
        self._unplaced = device is None
        dev = torch.device("cpu") if device is None else as_device(device)
        if _is_unknown(self._shape):
            if not self._allow_deferred_init:
                raise ValueError(f"Cannot initialize Parameter "
                                 f"'{self.name}' because it has invalid "
                                 f"shape: {self._shape}.")
            t = nn.UninitializedBuffer(device=dev, dtype=self._dtype) \
                if buffer else nn.UninitializedParameter(
                    req != "null", device=dev, dtype=self._dtype)
        else:
            t = torch.empty(self._shape, dtype=self._dtype, device=dev)
            if not buffer:
                t = nn.Parameter(t, req != "null")
            if req != "null":
                autograd._set_grad_req(t, req)
        self._data = t
        return t

    def _check_and_get(self):
        t = self._data
        if t is not None and not is_deferred(t):
            return t
        if t is not None or self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                f"because initialization was deferred. Actual "
                f"initialization happens during the first forward pass. "
                f"Please pass one batch of data through the network before "
                f"accessing Parameters.")
        raise RuntimeError(
            f"Parameter '{self.name}' has not been initialized. Note that "
            f"you should initialize parameters and create Trainer with "
            f"Block.collect_params() instead of Block.params because the "
            f"later does not include Parameters of nested child Blocks")

    def tensor(self):
        """The tensor itself: a leaf that takes a gradient unless
        ``grad_req='null'``."""
        return self._check_and_get()

    def grad_tensor(self):
        """The gradient buffer, a tensor (zeros until a ``backward``
        writes it)."""
        data = self._check_and_get()
        if self.grad_req == "null":
            raise RuntimeError(f"Cannot get gradient array for Parameter "
                               f"'{self.name}' because grad_req='null'")
        if data.grad is None:
            data.grad = torch.zeros_like(data)
        return data.grad

    def data(self, ctx=None):
        """The value as an NDArray over the tensor (``parameter.py:507``);
        a write through it writes the parameter."""
        return NDArray(self._check_and_get())

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer as an NDArray."""
        return NDArray(self.grad_tensor())

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        t = self._data
        if t is None:
            if self._deferred_init is not None:
                return [current_context()]
            raise RuntimeError(f"Parameter '{self.name}' has not been "
                               f"initialized")
        return [Context.from_device(t.device)]

    def zero_grad(self):
        """Zero the gradient buffer in place."""
        t = self._data
        if t is not None and t.grad is not None:
            t.grad.zero_()

    # ------------------------------------------------------------- lifecycle
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None, *, device=None):
        """Fill the tensor (``parameter.py:360``): with ``init``, else this
        parameter's own initializer, else ``default_init`` dispatching on
        the name (default :class:`Uniform`).  A standalone parameter makes
        its tensor on ``ctx`` (the current context by default); a block's
        tensor moves there first when ``ctx`` is given or it is unplaced.
        One whose shape is unknown is filled when the shape comes.
        ``device`` is the port's name for ``ctx``."""
        default_init = Uniform() if default_init is None else default_init
        own = self.init if init is None else init
        device = _one_device(ctx if device is None else device)
        t = self._data
        if t is not None and getattr(t, _INITIALIZED, False) and \
                not force_reinit:
            warnings.warn(f"Parameter '{self.name}' is already initialized, "
                          f"ignoring. Set force_reinit=True to "
                          f"re-initialize.", stacklevel=3)
            return
        if t is None:
            if _is_unknown(self._shape):
                if not self._allow_deferred_init:
                    raise ValueError(f"Cannot initialize Parameter "
                                     f"'{self.name}' because it has "
                                     f"invalid shape: {self._shape}.")
                self._deferred_init = (default_init, own, generator)
                return
            t = self._make_tensor(as_device(device), buffer=False)
        if is_deferred(t):
            self._deferred_init = (default_init, own, generator)
            return
        if device is None and self._unplaced:
            device = as_device(None)
        if device is not None and t.device != device:
            t.data = t.data.to(device)
        self._unplaced = False
        _fill(self.name, t, default_init, own, generator)

    def _finish_deferred_init(self, shape, device):
        """Give the uninitialised tensor ``shape`` on ``device`` and fill it
        if ``initialize`` was called."""
        self.shape = shape
        t = self._data
        if t is None or not is_deferred(t):
            return
        # outside inference mode, so that the new tensor is an ordinary one
        # even when the first forward runs under ``compile_grid``
        with torch.inference_mode(False):
            t.materialize(tuple(self._shape), device=device)
            self._apply_grad_req()
            self._unplaced = False
            if self._deferred_init is not None:
                default_init, own, generator = self._deferred_init
                self._deferred_init = None
                _fill(self.name, t, default_init, own, generator)

    def _load_init(self, value, ctx=None, cast_dtype=False,
                   dtype_source="current"):
        """Take ``value`` (a tensor or NDArray) as this parameter's, as
        ``parameter.py:274`` does: on ``ctx`` if given, else where the
        tensor is (the current context for an unplaced or standalone one);
        a tensor of unknown shape takes the value's.  Dtypes must match
        unless ``cast_dtype``: ``dtype_source="current"`` casts the value,
        ``"saved"`` gives the parameter the value's dtype.  The result
        counts as initialised."""
        if dtype_source not in ("current", "saved"):
            raise ValueError(f"dtype_source must be 'current' or 'saved', "
                             f"got {dtype_source!r}")
        value = tensor_of(value)
        device = _one_device(ctx)
        t = self._data
        if t is None:
            if self._shape is not None and not _is_unknown(self._shape) \
                    and tuple(self._shape) != tuple(value.shape):
                raise ValueError(
                    f"Failed loading Parameter '{self.name}' from saved "
                    f"params: shape incompatible expected {self._shape} vs "
                    f"saved {tuple(value.shape)}")
            if cast_dtype and dtype_source == "saved":
                self._dtype = value.dtype
            self._shape = tuple(value.shape)
            t = self._make_tensor(device or as_device(None))
        if device is None and self._unplaced:
            device = as_device(None)
        saved = cast_dtype and dtype_source == "saved"
        with torch.inference_mode(False), torch.no_grad():
            if cast_dtype and not saved:
                value = value.to(self._dtype if is_deferred(t) else t.dtype)
            elif saved and not is_deferred(t):
                t.data = t.data.to(value.dtype)
            want = value.dtype if saved else \
                (self._dtype if is_deferred(t) else t.dtype)
            if value.dtype != want:
                raise TypeError(f"{self.name}: file has {value.dtype}, the "
                                f"parameter is {want}")
            if is_deferred(t):
                t.materialize(tuple(value.shape), device=device or t.device,
                              dtype=want)
                self._apply_grad_req()
                self._shape = tuple(value.shape)
                self._deferred_init = None
            elif tuple(t.shape) != tuple(value.shape):
                raise ValueError(
                    f"{self.name}: file has shape {tuple(value.shape)}, the "
                    f"parameter {tuple(t.shape)}")
            elif device is not None and t.device != device:
                t.data = t.data.to(device)
            t.copy_(value)
        self._unplaced = False
        setattr(t, _INITIALIZED, True)

    def _reduce(self):
        """The value, copied to the CPU (``parameter.py:300``)."""
        return NDArray(self._check_and_get().detach().to("cpu", copy=True))

    def set_data(self, data):
        """Overwrite the value in place, keeping the tensor."""
        value = tensor_of(data)
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        with torch.no_grad():
            self._check_and_get().copy_(value)

    def cast(self, dtype):
        """Cast the value and its gradient buffer to ``dtype`` in place of
        the old ones (``mxnet_tpu/gluon/parameter.py:425``); the tensor
        object, and so the block's attribute, stays the same."""
        self._dtype = torch_dtype(dtype)
        self._var = None
        t = self._data
        if t is None or is_deferred(t):
            return
        with torch.no_grad():
            t.data = t.data.to(self._dtype)
            if t.grad is not None:
                t.grad = t.grad.to(self._dtype)

    def reset_ctx(self, ctx):
        """Move the value (and its gradient) to ``ctx``."""
        device = _one_device(ctx)
        t = self._data
        if t is None or is_deferred(t):
            return
        with torch.no_grad():
            t.data = t.data.to(device)
            if t.grad is not None:
                t.grad = t.grad.to(device)
        self._unplaced = False

    def var(self):
        """The symbol of this parameter (``parameter.py:584``): a variable
        of its name carrying its shape, dtype, ``lr_mult`` and
        ``wd_mult``."""
        from .. import symbol
        key = (self.shape, self._dtype, self.lr_mult, self.wd_mult)
        if self._var is None or self._var[0] != key:
            init = self.init
            if init is not None and not isinstance(init, (str,
                                                          Initializer)):
                init = None
            self._var = (key, symbol.var(
                self.name, shape=self.shape, dtype=dtype_of(self._dtype),
                lr_mult=self.lr_mult, wd_mult=self.wd_mult, init=init))
        return self._var[1]


class Constant(Parameter):
    """A parameter that takes no gradient, initialised from ``value``
    (``parameter.py:347``)."""

    def __init__(self, name, value):
        # nd.array's dtype rules: float64 and lists become float32
        self.value = array(value, ctx="cpu")
        super().__init__(name, grad_req="null", shape=self.value.shape,
                         dtype=self.value._data.dtype,
                         init=self._init_value, differentiable=False)

    def _init_value(self, name, t, generator=None):
        with torch.no_grad():
            t.copy_(self.value._data)

    def __repr__(self):
        return f"Constant {self.name} (shape={self.shape}, dtype={self.dtype})"

    @property
    def grad_req(self):
        return "null"

    @grad_req.setter
    def grad_req(self, req):
        if req != "null":
            warnings.warn(f"Constant parameter {self.name} does not support "
                          f"grad_req other than 'null', and new value {req} "
                          f"is ignored.")


def _one_device(ctx):
    """The device of ``ctx`` (a Context, a device, or MXNet's list of
    one), or None."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise ValueError(f"the port places a block on one device, got "
                             f"{ctx}")
        ctx = ctx[0]
    return None if ctx is None else as_device(ctx)


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    return "\n".join([lines[0]] + [num_spaces * " " + line
                                   for line in lines[1:]])


def _brief(names, limit=7):
    names = list(names)
    if len(names) > limit:
        return _brief(names[:limit // 2], limit) + ", ..., " + \
            _brief(names[-limit // 2:], limit)
    return ", ".join(f"'{n}'" for n in names)


class ParameterDict:
    """Parameters by name with prefix scoping and a shared dict
    (``parameter.py:404``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "{name}(\n{content}\n)".format(name=name, content="\n".join(
            [_indent(f"  {v}", 2) for v in self.values()]))

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, made with ``kwargs`` if neither
        this dict nor the shared one has it (``parameter.py:701``); an
        existing one must agree with ``kwargs`` (a 0 in a shape agrees with
        anything and is filled in)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if k == "shape" and v is not None:
                try:
                    param.shape = v
                except ValueError:
                    raise AssertionError(
                        f"Cannot retrieve Parameter '{name}' because desired "
                        f"attribute does not match with stored for "
                        f"attribute 'shape': desired '{v}' vs stored "
                        f"'{param.shape}'.") from None
            elif k == "dtype" and v is not None:
                if torch_dtype(v) != param._dtype:
                    raise AssertionError(
                        f"Cannot retrieve Parameter '{name}' because desired "
                        f"attribute does not match with stored for "
                        f"attribute 'dtype': desired '{v}' vs stored "
                        f"'{param.dtype}'.")
            elif hasattr(param, k) and getattr(param, k) is not None:
                if v is not None and v != getattr(param, k):
                    raise AssertionError(
                        f"Cannot retrieve Parameter '{name}' because desired "
                        f"attribute does not match with stored for "
                        f"attribute '{k}': desired '{v}' vs stored "
                        f"'{getattr(param, k)}'.")
            elif k in ("allow_deferred_init", "differentiable"):
                setattr(param, "_" + k, v)
            else:
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        """The constant ``prefix + name``, made from ``value`` if it is new
        (``parameter.py:772``)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'. Please specify "
                               f"value if you want to create a new "
                               f"constant.")
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None:
            if not isinstance(param, Constant):
                raise AssertionError(f"Parameter '{name}' already exists but "
                                     f"it is not a constant.")
            v = np.asarray(tensor_of(value).cpu() if isinstance(
                tensor_of(value), torch.Tensor) else value)
            if param.shape != v.shape or \
                    not (param.value.asnumpy() == v).all():
                raise AssertionError(f"Constant '{name}' already exists but "
                                     f"it's value doesn't match new value")
        return param

    def update(self, other):
        """Take every parameter of ``other`` (``parameter.py:817``)."""
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise AssertionError(
                        f"Cannot update self with other because they have "
                        f"different Parameters with the same name '{k}'")
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter (``parameter.py:829``) with ``init``
        (default :class:`Uniform`) or its own initializer."""
        init = Uniform() if init is None else init
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit,
                         generator=generator)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def list_ctx(self):
        out = []
        for p in self.values():
            for c in p.list_ctx():
                if c not in out:
                    out.append(c)
        return out

    def setattr(self, name, value):
        """Set ``name`` to ``value`` on every parameter
        (``parameter.py:872``): ``collect_params('.*beta|.*gamma|.*bias')
        .setattr('wd_mult', 0.0)``."""
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every value under its name, ``strip_prefix`` removed
        (``parameter.py:899``)."""
        arg_dict = {}
        for p in self.values():
            if not p.name.startswith(strip_prefix):
                raise ValueError(
                    f"Prefix '{strip_prefix}' is to be striped before "
                    f"saving, but Parameter's name '{p.name}' does not "
                    f"start with '{strip_prefix}'")
            arg_dict[p.name[len(strip_prefix):]] = p._reduce()._data
        serialization.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False,
             dtype_source="current"):
        """Read a file of :meth:`save` or ``export`` (``arg:``/``aux:``
        names taken), ``restore_prefix`` put back before each name
        (``parameter.py:924``)."""
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise AssertionError(
                        f"restore_prefix is '{restore_prefix}' but "
                        f"Parameters name '{name}' does not start with "
                        f"'{restore_prefix}'")
        lprefix = len(restore_prefix)
        loaded = serialization.load(filename)
        arg_dict = {restore_prefix + re.sub(r"^(arg|aux):", "", k): v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError(
                        f"Parameter '{name[lprefix:]}' is missing in file "
                        f"'{filename}', which contains parameters: "
                        f"{_brief(arg_dict)}. Please make sure source and "
                        f"target networks have the same prefix.")
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        f"Parameter '{name[lprefix:]}' loaded from file "
                        f"'{filename}' is not present in ParameterDict, "
                        f"which contains parameters "
                        f"{_brief(self._params)}. Set ignore_extra=True to "
                        f"ignore. ")
                continue
            self._params[name]._load_init(value, ctx, cast_dtype=cast_dtype,
                                          dtype_source=dtype_source)
