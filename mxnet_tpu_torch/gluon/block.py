"""Gluon's ``Block``, ``HybridBlock`` and ``SymbolBlock`` on
``torch.nn.Module`` (counterpart of ``mxnet_tpu/gluon/block.py:37-1039``).

Names.  A block takes its ``prefix`` as MXNet gives it: inside a parent's
``with self.name_scope():`` the parent's prefix plus ``<alias><count>_``
from the parent's counters (``dense0_``), outside any scope from the
thread's ``mx.name`` manager (``hybridsequential0_``); ``prefix=""``
shares the enclosing scope.  Its ``params`` is a ``ParameterDict`` under
that prefix (or a shared one, ``params=``), and ``collect_params()``
gathers every parameter of the block and its children under the prefixed
names (``resnetv10_stage1_conv0_weight``), the names ``Trainer`` sorts and
``export`` writes.  ``_collect_params_with_prefix``, ``save_parameters``
and ``load_parameters`` keep the structural names (the attribute path,
``features.5.0.body.0.weight``), as MXNet 1.5 does, so ``.params`` files of
either package load in the other.

Two registries, one source of tensors.  torch's registration (attribute
children, ``nn.Parameter``s and buffers) holds the tensors; the Gluon view
is derived from it: each registered tensor has one ``Parameter``
(``_reg_params``, by attribute name), made with the tensor, or by
:meth:`Block._sync_params` for one that plain torch code registered.  A
user block's ``self.w = self.params.get("w", shape=...)`` registers the
parameter's tensor with torch under ``w`` (a buffer when it takes no
gradient by nature) and keeps the ``Parameter`` as the attribute, as in
MXNet; the port's layers do the same (``self.weight`` is a ``Parameter``)
and read the tensor in ``forward`` from torch's registration
(``self._parameters["weight"]``), with no lookup through the
``Parameter``.

Calls.  A ``Block`` passes its arguments to ``forward`` as they come
(NDArrays in, NDArrays out).  A ``HybridBlock`` runs on tensors: NDArray
arguments are unwrapped once at its boundary and its results wrapped.  Its
default ``forward`` calls ``hybrid_forward(F, x, *args, **params)`` as
MXNet does, with ``F = mx.nd``, the inputs as NDArrays over the tensors (no
copy) and each parameter as a keyword NDArray.  The port's layers keep a
tensor ``forward`` (no NDArray wrapping on the measured paths) beside the
reference's ``hybrid_forward``, which ``export`` traces with ``F =
mx.sym``.  As in MXNet, only a call inside ``autograd.record()`` builds a
graph.

``hybridize()`` sets a flag: the port runs eagerly, so a hybridized block
records the signature of its last call (for ``export``) and changes
nothing else; ``compile_grid`` runs each serving bucket once under
``torch.inference_mode()`` and remembers its signature, for
``serving.ModelRuntime``'s compile-miss bookkeeping.

``SymbolBlock`` runs a graph (``SymbolBlock.imports`` of an exported
``-symbol.json``/``.params`` pair) on its own parameters with the
Executor's walk (``executor.py``), keeping torch's autograd graph inside
``record()``: an imported block fine-tunes, and its training-mode
BatchNorms run on the bn-stats kernel on the GPU.
"""
from __future__ import annotations

import copy
import re
import threading
import warnings
from collections import OrderedDict

import torch
from torch import nn

from .. import autograd
from .. import name as _names
from .. import ndarray as _nd
from .. import symbol as _sym
from ..executor import graph_plan, walk
from ..initializer import Uniform
from ..ndarray import serialization
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import Symbol
from .parameter import (Parameter, ParameterDict, _indent, _one_device,
                        is_deferred, tensor_of)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "io_signature",
           "is_deferred"]


def io_signature(tensors):
    """Shape/dtype signature key for a flat list of tensors — the one
    format shared by :meth:`HybridBlock.compile_grid`,
    :meth:`HybridBlock.compiled_signatures` and ``ModelRuntime``'s
    compile-miss check."""
    return (tuple(tuple(x.shape) for x in tensors),
            tuple(str(x.dtype) for x in tensors))


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_wrap(v) for v in x)
    return x


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _has_ndarray(args, kwargs):
    return any(isinstance(a, NDArray) for a in args) or \
        any(isinstance(v, NDArray) for v in kwargs.values())


def _own_state(module):
    yield from module.named_parameters(recurse=False)
    yield from module.named_buffers(recurse=False)


def _flatten(args):
    """(flat leaves, nesting format) of an argument structure
    (``mxnet_tpu/gluon/block.py:83``): -1 for None, 0 for one array,
    a list for a nested list."""
    if args is None:
        return [], -1
    if isinstance(args, (torch.Tensor, NDArray)):
        return [args], 0
    if isinstance(args, Symbol):
        n = len(args.list_outputs())
        return [args], (n if n > 1 else 0)
    if not isinstance(args, (list, tuple)):
        raise TypeError(f"HybridBlock arguments must be (nested) lists of "
                        f"arrays or Symbols, got {type(args)}")
    parts = [_flatten(a) for a in args]
    return [x for flat, _ in parts for x in flat], [f for _, f in parts]


def _regroup(args, fmt):
    if isinstance(fmt, int):
        if fmt == -1:
            return None, args
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    grouped = []
    for sub in fmt:
        piece, args = _regroup(args, sub)
        grouped.append(piece)
    return grouped, args


class _BlockScope:
    """The naming scope of a block (``mxnet_tpu/gluon/block.py:37-80``):
    children made inside ``with block.name_scope():`` take the block's
    prefix and its per-alias counters."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """(prefix, params) of a new block of alias ``hint``."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _names.current().get(None, hint) + "_"
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            counter = current._block._scope_counter
            count = counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            counter[hint] = count + 1
        parent = current._block._params
        params = ParameterDict(parent.prefix + prefix, parent._shared) \
            if params is None else ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if not self._block._empty_prefix:
            self._old_scope = getattr(_BlockScope._current, "value", None)
            _BlockScope._current.value = self
            self._name_scope = _names.Prefix(self._block.prefix)
            self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if not self._block._empty_prefix:
            scope, self._name_scope = self._name_scope, None
            scope.__exit__(ptype, value, trace)
            _BlockScope._current.value = self._old_scope


class _HookHandle:
    """A forward hook's handle: ``detach()`` (Gluon's name) or
    ``remove()`` (torch's, which the port's own callers use)."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    remove = detach


class Block(nn.Module):
    """Base of every layer and model (``mxnet_tpu/gluon/block.py:136``):
    a ``torch.nn.Module`` with MXNet's prefix, name scope, parameter
    dictionary, hooks and parameter files."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope_counter = {}
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join(f"  ({key}): {_indent(repr(block), 2)}"
                           for key, block in self._children.items())
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    def __setattr__(self, name, value):
        """A ``Parameter`` value registers its tensor with torch under
        ``name`` (unless :meth:`_new_param` already did) and stays the
        attribute (``block.py:160-177``); anything else goes to
        ``nn.Module``."""
        if isinstance(value, Parameter):
            if self._reg_params.get(name) is not value:
                self._register_param(name, value)
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def _register_param(self, name, param, device=None, buffer=None):
        """Register ``param``'s tensor (made on ``device`` if it has none:
        a buffer when ``buffer``, by default when it takes no gradient by
        nature) with torch under ``name``; returns the tensor."""
        if name in self._reg_params:
            raise AssertionError(
                f"Overriding Parameter attribute {name} is not allowed. If "
                f"you want to share parameters between blocks, please set "
                f"'params' at Block construction instead.")
        t = param._data
        if t is None:
            t = param._make_tensor(
                device, not param._differentiable if buffer is None
                else buffer)
        if isinstance(t, nn.Parameter):
            self.register_parameter(name, t)
        else:
            self.register_buffer(name, t)
        param._bind(t)
        self._reg_params[name] = param
        return t

    def _new_param(self, name, shape, dtype, device, init=None,
                   grad_req="write", differentiable=True, buffer=False):
        """A layer's Gluon parameter ``prefix + name``, its tensor
        registered with torch under ``name`` (made on ``device``, a buffer
        when ``buffer``): the shared dict's when it has one, else a new one
        (deferred where a width is 0).  The layer keeps the returned
        ``Parameter`` as its attribute."""
        param = self._params.get(name, shape=shape, dtype=dtype, init=init,
                                 grad_req=grad_req,
                                 allow_deferred_init=True,
                                 differentiable=differentiable)
        self._register_param(name, param, device, buffer)
        return param

    def _sync_params(self):
        """Give every tensor registered on this block a ``Parameter``
        (``prefix + attribute``), and rebind one whose tensor torch's
        registration replaced."""
        reg = self._reg_params
        for name, t in _own_state(self):
            p = reg.get(name)
            if p is None:
                full = self._params.prefix + name
                p = self._params._get_impl(full)
                if p is None:
                    p = Parameter(full, dtype=t.dtype,
                                  allow_deferred_init=True,
                                  differentiable=name in self._parameters)
                    self._params._params[full] = p
                reg[name] = p
            if p._ref is None or p._ref() is not t:
                p._bind(t)

    @property
    def _children(self):
        """``{name: child block}`` in registration order."""
        return OrderedDict((k, m) for k, m in self._modules.items()
                           if m is not None)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """The scope in which children take this block's prefix
        (``block.py:241``)."""
        return _BlockScope(self)

    @property
    def params(self):
        """This block's own ``ParameterDict``, without its children's
        (``block.py:270``)."""
        self._sync_params()
        return self._params

    def register_child(self, block, name=None):
        """Register a child block, under ``str(len(children))`` by
        default (``block.py:423``)."""
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    def collect_params(self, select=None):
        """A ``ParameterDict`` of this block's and its children's
        parameters under their prefixed names (``block.py:278``);
        ``select`` is a regular expression the names must match
        (``'.*beta|.*gamma|.*bias'``)."""
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None
        self._collect_into(ret, pattern)
        return ret

    def _collect_into(self, ret, pattern):
        self._sync_params()
        ret.update({k: v for k, v in self._params.items()
                    if pattern is None or pattern.match(k)})
        for child in self._modules.values():
            if isinstance(child, Block):
                child._collect_into(ret, pattern)

    def _collect_params_with_prefix(self):
        """``{structural name: tensor}``, the names ``save_parameters``
        writes (``block.py:244``)."""
        out = dict(self.named_parameters())
        out.update(self.named_buffers())
        return out

    # ------------------------------------------------------------ lifecycle
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Fill every parameter with ``init`` (default :class:`Uniform`),
        dispatching on its name as MXNet does, or with its own
        initializer; a deferred one is filled when it materialises.  One
        already initialised (by an earlier call or ``load_parameters``) is
        kept, with a warning, unless ``force_reinit``
        (``mxnet_tpu/gluon/block.py:517-523``).  ``ctx`` (a Context or
        device; MXNet's list of one is taken too) moves the ones filled
        here there first, and an unplaced one goes to the current context
        without it; a ``generator`` must be on that device.  ``verbose`` is
        taken for MXNet's signature and changes nothing."""
        init = Uniform() if init is None else init
        _one_device(ctx)                       # one device, or raise
        seen = set()
        for module in self.modules():
            if not isinstance(module, Block):
                continue
            module._sync_params()
            for name, _ in _own_state(module):
                p = module._reg_params[name]
                if id(p) not in seen:
                    seen.add(id(p))
                    p.initialize(None, ctx, init, force_reinit, generator)
        for p in self.collect_params().values():
            if id(p) not in seen:
                p.initialize(None, ctx, init, force_reinit, generator)

    def hybridize(self, active=True, **kwargs):
        """Hybridize the children (``block.py:501``)."""
        for child in self._children.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter and buffer (running statistics included)
        and their gradients to ``dtype`` (``mxnet_tpu/gluon/block.py:369``,
        ``Parameter.cast``); a deferred one takes ``dtype`` when it
        materialises.  A layer may keep another dtype for its own
        (``_param_dtype``: BatchNorm stays fp32 under fp16)."""
        for module in self.modules():
            own = getattr(module, "_param_dtype", None)
            want = dtype if own is None else own(dtype)
            if not isinstance(module, Block):
                for _, t in _own_state(module):
                    t.data = t.data.to(want)
                continue
            module._sync_params()
            for name, _ in _own_state(module):
                module._reg_params[name].cast(want)

    def register_forward_pre_hook(self, hook, *args, **kwargs):
        """``hook(block, inputs)`` before each forward; returns a handle
        with ``detach()``."""
        return _HookHandle(super().register_forward_pre_hook(
            hook, *args, **kwargs))

    def register_forward_hook(self, hook, *args, **kwargs):
        """``hook(block, inputs, outputs)`` after each forward; returns a
        handle with ``detach()``.  A hybrid block's hooks see its inputs
        and outputs as tensors."""
        return _HookHandle(super().register_forward_hook(
            hook, *args, **kwargs))

    def __call__(self, *args, **kwargs):
        # as in MXNet, only a forward inside autograd.record() builds a
        # graph; the check costs nothing below the outermost block
        if torch.is_grad_enabled() and not autograd.is_recording():
            with torch.no_grad():
                return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)

    def summary(self, *inputs):
        """Print each layer's output shape and parameter counts by running
        one forward with hooks (``block.py:559``)."""
        rows, counted, hooks = [], set(), []

        def shape_str(x):
            if isinstance(x, (torch.Tensor, NDArray)):
                return str(tuple(x.shape))
            if isinstance(x, (list, tuple)):
                return str([shape_str(i) for i in x]).replace("'", "")
            return str(x)

        def record(blk, _, outputs):
            total = trainable = shared = 0
            for p in blk.params.values():
                size = p.tensor().numel()
                total += size
                if p.grad_req != "null":
                    trainable += size
                if id(p) in counted:
                    shared += size
                counted.add(id(p))
            rows.append((f"{type(blk).__name__}-{len(rows)}",
                         shape_str(outputs), total, trainable, shared))

        one = inputs[0] if len(inputs) == 1 else list(inputs)
        rows.append(("Input", shape_str(one), 0, 0, 0))
        try:
            for module in self.modules():
                if isinstance(module, Block):
                    hooks.append(module.register_forward_hook(record))
            self(*inputs)
            fmt = "{:>20}  {:>42} {:>15}".format
            total = sum(r[2] for r in rows)
            trainable = sum(r[3] for r in rows)
            shared = sum(r[4] for r in rows)
            lines = ["-" * 80, fmt("Layer (type)", "Output Shape",
                                   "Param #"), "=" * 80]
            lines += [fmt(label, shape, n) for label, shape, n, _, _ in rows]
            lines += ["=" * 80,
                      "Parameters in forward computation graph, duplicate "
                      "included",
                      f"   Total params: {total}",
                      f"   Trainable params: {trainable}",
                      f"   Non-trainable params: {total - trainable}",
                      f"Shared params in forward computation graph: "
                      f"{shared}",
                      f"Unique parameters in model: {total - shared}",
                      "-" * 80]
            print("\n".join(lines))
        finally:
            for h in hooks:
                h.detach()

    # ---------------------------------------------------------------- files
    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter and buffer to an MXNet ``.params`` file
        under its structural name (``mxnet_tpu/gluon/block.py:252``)."""
        params = self._collect_params_with_prefix()
        deferred = [k for k, v in params.items() if is_deferred(v)]
        if deferred:
            raise RuntimeError(
                f"parameters {deferred[:4]} have no shape yet (deferred); run "
                f"a forward or load_parameters before saving")
        serialization.save(filename,
                           {k: v.detach() for k, v in params.items()})

    def save_params(self, filename):
        """MXNet's pre-1.4 call: ``collect_params().save`` with this
        block's prefix stripped."""
        warnings.warn("save_params is deprecated; use save_parameters "
                      "(note the file formats differ)", DeprecationWarning,
                      stacklevel=2)
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """MXNet's pre-1.4 name of :meth:`load_parameters`."""
        warnings.warn("load_params is deprecated; use load_parameters",
                      DeprecationWarning, stacklevel=2)
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file written by ``save_parameters`` (this package's or the
        JAX package's; ``mxnet_tpu/gluon/block.py:276-312``), or by
        ``save_params``/``collect_params().save`` (prefixed names without
        this block's prefix).  A parameter the file lacks raises unless
        ``allow_missing`` (it keeps its value), a name the block lacks
        unless ``ignore_extra``; a file and a block both without parameters
        load as nothing.  Each value lands on ``ctx`` if given (a Context, a
        device or a list of one), else on its parameter's device (the
        current context for an unplaced one); a deferred parameter takes
        the file's shape.  Dtypes must match unless ``cast_dtype``: then
        ``dtype_source="current"`` casts each value to its parameter's
        dtype, ``"saved"`` gives the parameter the file's.  A loaded
        parameter counts as initialised (see :meth:`initialize`)."""
        if dtype_source not in ("current", "saved"):
            raise ValueError(f"dtype_source must be 'current' or 'saved', "
                             f"got {dtype_source!r}")
        loaded = serialization.load(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not isinstance(loaded, dict):
            raise ValueError(f"{filename} holds unnamed arrays")
        if not any("." in k for k in loaded) and \
                not set(params) & set(loaded):
            # the collect_params().save() format: prefixed names
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        missing = [k for k in params if k not in loaded]
        extra = [k for k in loaded if k not in params]
        if (missing and not allow_missing) or (extra and not ignore_extra):
            raise KeyError(
                f"{filename} does not match this block: parameters "
                f"{missing[:8]} are missing from it, and it holds "
                f"{extra[:8]}, which the block does not have "
                f"(allow_missing, ignore_extra)")
        by_tensor = {}
        for module in self.modules():
            if isinstance(module, Block):
                module._sync_params()
                for name, t in _own_state(module):
                    by_tensor[id(t)] = module._reg_params[name]
        for name, t in params.items():
            if name in loaded:
                p = by_tensor.get(id(t))
                if p is None:           # a plain torch module's tensor
                    p = Parameter(name, dtype=t.dtype)
                    p._bind(t)
                p._load_init(loaded[name], ctx, cast_dtype, dtype_source)


class HybridBlock(Block):
    """A block with MXNet's ``hybrid_forward(F, x, *args, **params)``
    (``mxnet_tpu/gluon/block.py:387``): eagerly ``F`` is ``mx.nd`` and the
    parameters come as keyword NDArrays; traced by :meth:`export`, ``F``
    is ``mx.sym`` and they are the parameters' variables.  A subclass may
    instead define a tensor ``forward`` (the port's layers define both)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._warmed = set()
        self._active = False
        self._flags = []
        self._in_sig = None

    def __call__(self, *args, **kwargs):
        if args and isinstance(args[0], Symbol):
            return self._call_symbol(*args)
        if self._active:
            try:
                flat, fmt = _flatten(list(args))
                self._in_sig = (len(flat), fmt)
            except TypeError:
                pass
        if _has_ndarray(args, kwargs):
            return _wrap(Block.__call__(
                self, *(_unwrap(a) for a in args),
                **{k: _unwrap(v) for k, v in kwargs.items()}))
        return Block.__call__(self, *args, **kwargs)

    def hybridize(self, active=True, **kwargs):
        """Mark this block and its children hybridized; the port runs
        eagerly, so this only lets :meth:`export` trace the block after a
        forward.  ``static_alloc``/``static_shape`` are taken and change
        nothing."""
        self._active = active
        self._flags = list(kwargs.items())
        super().hybridize(active, **kwargs)

    def forward(self, x, *args):
        """The eager body: ``hybrid_forward(mx.nd, ...)`` on NDArrays over
        the input tensors and the parameters' tensors, back to tensors at
        the boundary (``block.py:909``)."""
        reg = self._reg_params
        if len(reg) != len(self._parameters) + len(self._buffers):
            self._sync_params()
        if any(is_deferred(p._data) for p in reg.values()):
            self._deferred_infer(x, args)
        params = {name: NDArray(p._data) for name, p in reg.items()}
        out = self.hybrid_forward(_nd, _wrap(x), *_wrap(args), **params)
        return _unwrap(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Override with the computation, written with ``F``
        (``block.py:942``)."""
        raise NotImplementedError(
            f"{type(self).__name__} defines no hybrid_forward: its tensor "
            f"forward runs eagerly, and nothing traces it symbolically")

    def infer_shape(self, *args):
        """Set the shapes of deferred parameters from the inputs; a block
        with deferred parameters of its own implements it
        (``block.py:448``)."""
        raise NotImplementedError(
            f"layer {self.name} has deferred-initialized parameters but does "
            f"not implement infer_shape; pass explicit in_units/in_channels "
            f"or implement infer_shape")

    def _deferred_infer(self, x, args):
        self.infer_shape(_wrap(x), *_wrap(args))
        device = tensor_of(x).device
        for p in self._reg_params.values():
            if is_deferred(p._data):
                p._finish_deferred_init(p._shape, device)

    def _call_symbol(self, *args):
        """``hybrid_forward`` with ``F = mx.sym`` on Symbol inputs and the
        parameters' variables, inside this block's name scope."""
        self._sync_params()
        params = {name: p.var() for name, p in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(_sym, *args, **params)

    def _get_graph_from_sig(self, n_flat, fmt):
        """The symbolic graph of this block for inputs of ``n_flat``
        arrays in nesting ``fmt``: variables ``data`` (``data0``... for
        several) (``block.py:673-688``)."""
        inputs = [_sym.var("data") if n_flat == 1 else _sym.var(f"data{i}")
                  for i in range(n_flat)]
        grouped = _regroup(inputs, fmt)[0]
        out = self._call_symbol(*(grouped if isinstance(grouped, list)
                                  else [grouped]))
        flat, _ = _flatten(out)
        return inputs, _sym.Group(flat)

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``path-symbol.json`` (the graph ``hybrid_forward`` traces)
        and ``path-%04d.params`` (every parameter, ``arg:``/``aux:``
        named), MXNet's checkpoint pair (``block.py:731-751``).  Needs
        ``hybridize()`` and one forward first, as there.  Returns the two
        file names."""
        if not self._active or self._in_sig is None:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        sym_file = f"{path}-symbol.json"
        _, out = self._get_graph_from_sig(*self._in_sig)
        out.save(sym_file)
        arg_names = set(out.list_arguments())
        arg_dict = {}
        for name, param in self.collect_params().items():
            kind = "arg" if name in arg_names else "aux"
            arg_dict[f"{kind}:{name}"] = param._reduce()._data
        params_file = "%s-%04d.params" % (path, epoch)
        serialization.save(params_file, arg_dict)
        return sym_file, params_file

    # --------------------------------------------------------------- serving
    def compile_grid(self, make_example, buckets):
        """Run each bucket's example once in inference mode; returns
        ``{bucket: signature}``.  ``make_example(bucket)`` returns the input
        list for that bucket."""
        sigs = {}
        with torch.inference_mode():
            for bucket in buckets:
                args = make_example(bucket)
                self(*args)
                sigs[bucket] = io_signature(args)
        self._warmed.update(sigs.values())
        return sigs

    def compiled_signatures(self, training=None):
        """Signatures warmed by :meth:`compile_grid`.  Warming runs in
        inference mode only, so ``training=True`` has none."""
        return frozenset() if training else frozenset(self._warmed)


class SymbolBlock(HybridBlock):
    """A block that runs a Symbol graph on its own parameters
    (``mxnet_tpu/gluon/block.py:683``): every argument of ``outputs``
    that is not an input is a parameter (its graph name, no prefix),
    every auxiliary state one without gradient."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A block from ``export``'s files (``block.py:942-1039``): the
        graph of ``symbol_file`` with inputs ``input_names`` and, when
        ``param_file`` is given, its values on ``ctx`` (the current
        context by default), each parameter in the file's dtype."""
        sym = _sym.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [_sym.var(n) for n in input_names])
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx, cast_dtype=True,
                                      dtype_source="saved")
        return ret

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=None)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = outputs[0] if len(outputs) == 1 else _sym.Group(
                outputs)
        self._output_sym = outputs
        self._input_names = []
        for i in inputs:
            if len(i.list_outputs()) != 1:
                raise AssertionError(f"Input symbols must be variable, but "
                                     f"{i} is an output of operators")
            self._input_names.append(i.list_outputs()[0])
        aux = outputs.list_auxiliary_states()
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self._params.get(name, allow_deferred_init=True)
        for name in aux:
            self._params.get(name, grad_req="null", allow_deferred_init=True,
                             differentiable=False)
        # torch attribute names: the graph names, their common prefix
        # stripped at an underscore (``block.py:1093``), dots made safe
        names = list(self._params.keys())
        common = names[0] if names else ""
        for n in names[1:]:
            while not n.startswith(common):
                common = common[:-1]
        common = common[:common.rfind("_") + 1] if "_" in common else ""
        for n, p in self._params.items():
            self._register_param(n[len(common):].replace(".", "_"), p)
        # the variables in walk order, the plan per (mode, device)
        self._vars = [(id(n), n.name) for n in outputs._topo()
                      if n.op is None]
        self._heads_at = [(id(n), i) for n, i in outputs._outputs]
        self._plans = {}

    def _alias(self):
        return "symbolblock"

    def infer_shape(self, *args):
        """Shapes of deferred parameters from the graph and the inputs'
        shapes."""
        shapes = {n: tuple(a.shape) for n, a in zip(self._input_names,
                                                    args)}
        arg_shapes, _, aux_shapes = self._output_sym.infer_shape(**shapes)
        names = self._output_sym.list_arguments() + \
            self._output_sym.list_auxiliary_states()
        for name, shape in zip(names, list(arg_shapes) + list(aux_shapes)):
            if name in self._params:
                self._params[name].shape = shape

    def _deferred_infer(self, x, args):
        self.infer_shape(x, *args)
        for p in self._params.values():
            if is_deferred(p._data):
                p._finish_deferred_init(p._shape, x.device)

    def forward(self, x, *args):
        """The graph on tensors: the Executor's walk with the parameters'
        tensors as the variables, in training mode under
        ``autograd.is_training()`` (BatchNorm's batch statistics, its
        moving ones updated in place)."""
        inputs = (x,) + args
        if any(is_deferred(p._data) for p in self._params.values()):
            self._deferred_infer(x, args)
        training = autograd.is_training()
        key = (training, x.device)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = graph_plan(
                self._output_sym, training, self._heads_at, x.device)
        env = dict(zip(self._input_names, inputs))
        vals = {}
        for node_id, name in self._vars:
            if name in env:
                vals[(node_id, 0)] = env[name]
            else:
                vals[(node_id, 0)] = self._params[name]._data
        params = self._params
        walk(plan, vals, x.device,
             (lambda n: params[n]._data) if training else None)
        outs = [vals[s] for s in self._heads_at]
        return outs[0] if len(outs) == 1 else outs

    def _call_symbol(self, *args):
        """The graph, its inputs composed with ``args``."""
        ret = copy.copy(self._output_sym)
        return ret(**{n: a for n, a in zip(self._input_names, args)})

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
