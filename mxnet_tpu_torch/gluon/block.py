"""``HybridBlock`` on ``torch.nn.Module`` (counterpart of
``mxnet_tpu/gluon/block.py``, the part the serving and training slices
need).

PyTorch runs eagerly, so ``hybridize()`` is accepted and changes nothing,
and "compiling" a bucket ladder (``compile_grid``) means running each bucket
once under ``torch.inference_mode()`` and remembering its signature, so that
``serving.ModelRuntime`` keeps its warmed-shape bookkeeping and its
``serving.compile_miss`` counter.

Parameters are ``nn.Parameter``s and non-learned state (BatchNorm's running
statistics) is a buffer; both go by Gluon's structural names, the dotted
attribute path (``features.1.running_var``), which is what torch's own
naming gives.  A layer built with an unknown input width (``in_channels=0``,
``in_units=0``) holds an uninitialised parameter, Gluon's
``allow_deferred_init`` (``mxnet_tpu/gluon/parameter.py:28-37``): its shape
is fixed by the first forward, on the input's device, or by
``load_parameters``, from the file.  ``initialize()`` fills such a
parameter when it is materialised.  As in Gluon
(``mxnet_tpu/gluon/parameter.py:127-131``), a tensor that ``initialize``
filled or ``load_parameters`` loaded is initialised: a later
``initialize()`` keeps it, with MXNet's warning, unless
``force_reinit=True``.  A layer's ``*_initializer`` arguments name the
initializer of one parameter (``_param_inits``); ``initialize``'s own
initializer fills the rest.  ``collect_params()`` gives each of them
a Gluon ``Parameter`` (``parameter.py``) under the same names, for
``Trainer``.

NDArrays.  A block called with any ``mx.nd`` NDArray among its arguments
runs on their tensors and returns NDArrays; the unwrapping happens once, at
the outermost call, so inner blocks see tensors.  ``Parameter.data()``
still returns the tensor (ROADMAP.md).
"""
from __future__ import annotations

import re
import warnings

import torch
from torch import nn
from torch.nn.parameter import UninitializedTensorMixin

from .. import autograd
from ..context import as_device
from ..initializer import Initializer, Uniform, create
from ..ndarray import serialization
from ..ndarray.ndarray import NDArray
from .parameter import Parameter

__all__ = ["HybridBlock", "io_signature", "is_deferred"]


def io_signature(tensors):
    """Shape/dtype signature key for a flat list of tensors — the one
    format shared by :meth:`HybridBlock.compile_grid`,
    :meth:`HybridBlock.compiled_signatures` and ``ModelRuntime``'s
    compile-miss check."""
    return (tuple(tuple(x.shape) for x in tensors),
            tuple(str(x.dtype) for x in tensors))


def is_deferred(t):
    """True for a parameter or buffer whose shape is not known yet."""
    return isinstance(t, UninitializedTensorMixin)


def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_wrap(v) for v in x)
    return x


def _own_state(module):
    yield from module.named_parameters(recurse=False)
    yield from module.named_buffers(recurse=False)


def _one_device(ctx):
    """The device of ``ctx`` (a Context, a device, or MXNet's list of
    one), or None."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise ValueError(f"the port places a block on one device, got "
                             f"{ctx}")
        ctx = ctx[0]
    return None if ctx is None else as_device(ctx)


# attribute set on a tensor that ``initialize`` filled or a file loaded
_INITIALIZED = "_mx_initialized"


def _fill(module, name, t, init, generator):
    """Fill ``t`` (``module``'s attribute ``name``) with the layer's own
    initializer for it, if it names one, else with ``init``; the
    per-parameter one skips the name rules, as Gluon's does
    (``mxnet_tpu/gluon/parameter.py:161-171``)."""
    own = getattr(module, "_param_inits", {}).get(name)
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


class HybridBlock(nn.Module):
    """A Gluon-style block: ``forward`` is the eager body, parameters are
    ``nn.Parameter``s, ``initialize`` fills them from a generator."""

    def __init__(self):
        super().__init__()
        self._warmed = set()
        # (init, generator) for parameters that materialise later
        self._deferred_init = None

    def __call__(self, *args, **kwargs):
        if any(isinstance(a, NDArray) for a in args) or \
                any(isinstance(v, NDArray) for v in kwargs.values()):
            return _wrap(self.__call__(
                *(_unwrap(a) for a in args),
                **{k: _unwrap(v) for k, v in kwargs.items()}))
        # as in MXNet, only a forward inside autograd.record() builds a
        # graph; the check costs nothing below the outermost block
        if torch.is_grad_enabled() and not autograd.is_recording():
            with torch.no_grad():
                return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; eager mode is the only mode."""

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Fill every parameter and buffer with ``init`` (default
        :class:`Uniform`), dispatching on its name as MXNet does, or with
        the initializer its layer names for it; a deferred one is filled
        when it materialises.  One already initialised (by an earlier call
        or ``load_parameters``) is kept, with a warning, unless
        ``force_reinit`` (``mxnet_tpu/gluon/block.py:517-523``).  ``ctx``
        (a Context or device; MXNet's list of one is taken too) moves the
        ones filled here there first; a ``generator`` must be on that
        device.  ``verbose`` is taken for MXNet's signature and changes
        nothing (the JAX package's initializers only record it)."""
        init = Uniform() if init is None else init
        device = _one_device(ctx)
        for module in self.modules():
            for name, t in _own_state(module):
                if getattr(t, _INITIALIZED, False) and not force_reinit:
                    warnings.warn(f"Parameter '{name}' is already "
                                  f"initialized, ignoring. Set "
                                  f"force_reinit=True to re-initialize.",
                                  stacklevel=2)
                    continue
                if is_deferred(t):
                    module._deferred_init = (init, generator)
                    continue
                if device is not None:
                    t.data = t.data.to(device)
                _fill(module, name, t, init, generator)

    def _materialize(self, shapes, device):
        """Give each deferred ``{attribute: shape}`` its shape on
        ``device`` and fill it if ``initialize`` was called."""
        # outside inference mode, so that the new tensors are ordinary ones
        # even when the first forward runs under ``compile_grid``
        with torch.inference_mode(False):
            for name, shape in shapes.items():
                t = getattr(self, name)
                if not is_deferred(t):
                    continue
                t.materialize(tuple(shape), device=device)
                if self._deferred_init is not None:
                    init, generator = self._deferred_init
                    _fill(self, name, t, init, generator)

    # ------------------------------------------------------------ parameters
    def _collect_params_with_prefix(self):
        """``{structural name: parameter or buffer}``, the names
        ``save_parameters`` writes (``mxnet_tpu/gluon/block.py:244``)."""
        out = dict(self.named_parameters())
        out.update(self.named_buffers())
        return out

    def collect_params(self, select=None):
        """``{structural name: Parameter}`` for every parameter and buffer
        of this block and its children (``mxnet_tpu/gluon/block.py:229``);
        ``select`` is a regular expression the names must match.  Running
        statistics have ``grad_req='null'``."""
        pattern = re.compile(select) if select else None
        return {name: Parameter.of(name, t)
                for name, t in self._collect_params_with_prefix().items()
                if pattern is None or pattern.match(name)}

    def cast(self, dtype):
        """Cast every parameter and buffer (running statistics included)
        and their gradients to ``dtype`` (``mxnet_tpu/gluon/block.py:369``,
        ``Parameter.cast``); a deferred one takes ``dtype`` when it
        materialises.  A layer may keep another dtype for its own
        (``_param_dtype``: BatchNorm stays fp32 under fp16)."""
        params = self.collect_params()          # Gluon names made first
        by_tensor = {id(p._data): p for p in params.values()}
        for module in self.modules():
            own = getattr(module, "_param_dtype", None)
            for _, t in _own_state(module):
                by_tensor[id(t)].cast(dtype if own is None else own(dtype))

    def save_parameters(self, filename):
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

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file written by ``save_parameters`` (this package's or the
        JAX package's; ``mxnet_tpu/gluon/block.py:276-312``).  A parameter
        the file lacks raises unless ``allow_missing`` (it keeps its value),
        a name the block lacks unless ``ignore_extra``; a file and a block
        both without parameters load as nothing.  Each value lands on
        ``ctx`` if given (a Context, a device or a list of one), else on
        its parameter's device; a deferred parameter takes the file's
        shape there.  Dtypes must match unless ``cast_dtype``: then
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
        missing = [k for k in params if k not in loaded]
        extra = [k for k in loaded if k not in params]
        if (missing and not allow_missing) or (extra and not ignore_extra):
            raise KeyError(
                f"{filename} does not match this block: parameters "
                f"{missing[:8]} are missing from it, and it holds "
                f"{extra[:8]}, which the block does not have "
                f"(allow_missing, ignore_extra)")
        device = _one_device(ctx)
        with torch.inference_mode(False), torch.no_grad():
            for name, t in params.items():
                if name not in loaded:
                    continue
                value = loaded[name]
                saved = cast_dtype and dtype_source == "saved"
                if cast_dtype and not saved:
                    value = value.to(t.dtype)
                elif saved and not is_deferred(t):
                    t.data = t.data.to(value.dtype)
                want = value.dtype if saved else t.dtype
                if value.dtype != want:
                    raise TypeError(f"{name}: file has {value.dtype}, the "
                                    f"parameter is {t.dtype}")
                if is_deferred(t):
                    t.materialize(tuple(value.shape), device=device,
                                  dtype=want)
                elif tuple(t.shape) != tuple(value.shape):
                    raise ValueError(
                        f"{name}: file has shape {tuple(value.shape)}, the "
                        f"parameter {tuple(t.shape)}")
                elif device is not None:
                    t.data = t.data.to(device)
                t.copy_(value)
                setattr(t, _INITIALIZED, True)

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
