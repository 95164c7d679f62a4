"""Executor: forward and backward over a bound Symbol (the port's
counterpart of ``mxnet_tpu/executor.py``).

The JAX package traces the graph into one jitted function and takes
``jax.vjp`` of it.  Here :meth:`Executor.forward` walks the graph in
topological order (``Symbol._plan``: attributes filtered and parsed once
per mode), one call of the port's op table per node, so a training-mode
``BatchNorm`` on a CUDA tensor launches the bn-stats kernel
(``ops/bn_stats.py``).  In training, the arguments whose ``grad_req`` is
not ``'null'`` enter the walk as fresh autograd leaves over the bound
tensors, and :meth:`backward` is ``torch.autograd.grad`` of the walk's
outputs, written into the gradient arrays by ``grad_req``: ``'write'``
overwrites, ``'add'`` accumulates.  The walk's graph lives from a training
forward to the next ``backward`` only.

Semantics held to the JAX package: mode-dependent ops (``BatchNorm``,
``Dropout``) get ``__training__``; stochastic ones the generator of the
executor's device (``mx.random``); a training forward folds each
BatchNorm's batch statistics into its auxiliary states once,
``momentum * old + (1 - momentum) * batch``; outputs never share memory
with the bound arrays.  ``backward()`` without head gradients takes ones,
and is refused when an output is not a loss head (``SoftmaxOutput``),
as in MXNet; the JAX package takes ones there too.  A ``backward``
after an inference forward recomputes a training forward (without
touching the auxiliary states or the outputs), as the JAX package
recomputes one.

One context per executor: several contexts (multi-device data
parallelism, ``set_data_parallel``) are ROADMAP.md queue 1 item 9.
"""
from __future__ import annotations

import numpy as np
import torch

from . import random as _rnd
from .context import Context, current_context
from .ndarray import NDArray
from .ndarray.ndarray import _write
from .ops.nn import update_moving_stats
from .symbol.symbol import LOSS_OPS, STOCHASTIC, _op_params

__all__ = ["Executor", "check_single_context", "tensor_like", "graph_plan",
           "walk"]


def check_single_context(ctx):
    """The one :class:`Context` of ``ctx`` (``None``: the current context,
    the GPU unless the caller asked for the CPU); several raise."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise NotImplementedError(
                f"{len(ctx)} contexts {list(ctx)}: multi-device data "
                f"parallelism is not ported yet (ROADMAP.md, queue 1 item "
                f"9); bind one context")
        ctx = ctx[0]
    if ctx is None:
        return current_context()
    return Context(ctx) if isinstance(ctx, Context) else \
        Context.from_device(ctx)


def tensor_like(v, like):
    """``v`` (an NDArray, tensor or array-like) as a tensor on ``like``'s
    device and dtype."""
    t = v._data if isinstance(v, NDArray) else v
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(v))
    return t.to(device=like.device, dtype=like.dtype)


def graph_plan(symbol, is_train, heads_at, device):
    """``symbol``'s steps (``Symbol._plan``) with, for each, the output
    slots to keep and the slots its inputs free: a value lives from the
    node that makes it to its last consumer (or to the end, for a head in
    ``heads_at``), so the walk holds no more than autograd saves.  An op
    that makes its output from no input makes it on ``device``."""
    steps = symbol._plan(is_train)
    last = {s: i for i, step in enumerate(steps) for s in step[3]}
    for s in heads_at:
        last[s] = len(steps)
    plan = []
    for i, (node, fn, attrs, slots, aux) in enumerate(steps):
        if not slots and _op_params(node.op)[2]:
            attrs["ctx"] = device
        keep = [j for j in range(node.num_outputs) if (id(node), j) in last]
        free = [s for s in dict.fromkeys(slots) if last[s] == i]
        plan.append((id(node), node.name, node.num_outputs, fn, attrs,
                     slots, aux, node.op.name in STOCHASTIC, keep, free))
    return plan


def walk(plan, vals, device, aux_of=None, monitor=None):
    """Run ``plan`` over ``vals`` (``{(node id, output): tensor}``, the
    variables' values on entry, the heads' on exit), one op-table call a
    node, under the caller's grad mode: torch autograd records the walk
    where grad is enabled.  ``aux_of(name)`` gives the tensor of an
    auxiliary state, into which a training BatchNorm folds its batch
    statistics in place (``momentum``); ``None`` leaves them.
    ``monitor(name, NDArray)`` sees every node's outputs."""
    gen = None
    for (key, name, n_out, fn, attrs, slots, aux, stochastic, keep,
         free) in plan:
        if stochastic:
            # the device's generator now: mx.random.seed replaces it
            gen = gen or _rnd.generator(device)
            attrs = dict(attrs, generator=gen)
        out = fn(*[vals[s] for s in slots], **attrs)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        for s in free:
            del vals[s]
        for i in keep:
            vals[(key, i)] = out[i]
        if aux is not None and aux_of is not None:
            mean, var = (aux_of(n) for n in aux[1])
            update_moving_stats(mean, var, out[1], out[2], aux[0])
        if monitor is not None:
            for i in range(n_out):
                monitor(name if n_out == 1 else f"{name}_output{i}",
                        NDArray(out[i].detach()))


class Executor:
    """A Symbol bound to arrays: ``arg_dict``, ``grad_dict`` (the
    arguments whose ``grad_req`` is not ``'null'``), ``aux_dict``, all
    ``{name: NDArray}``."""

    def __init__(self, symbol, ctx, arg_dict, grad_dict, grad_req_dict,
                 aux_dict):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device()
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.grad_req = grad_req_dict
        self.aux_dict = aux_dict
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        missing = [n for n in self.arg_names if n not in self.arg_dict]
        if missing:
            raise ValueError(f"arguments {missing} must be provided to bind")
        order = symbol._topo()
        self._vars = [(id(n), n.name) for n in order if n.op is None]
        self._heads_at = [(id(n), i) for n, i in symbol._outputs]
        self._loss_heads = all(n.op is not None and n.op.name in LOSS_OPS
                               for n, _ in symbol._outputs)
        self._plans = {}
        self._outputs = None
        self._heads = None            # (output tensors, {name: leaf})
        self._monitor = None

    # ------------------------------------------------------------ properties
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    @property
    def outputs(self):
        return self._outputs

    # --------------------------------------------------------------- execute
    def _plan(self, is_train):
        plan = self._plans.get(is_train)
        if plan is None:
            plan = self._plans[is_train] = graph_plan(
                self._symbol, is_train, self._heads_at, self._device)
        return plan

    def _run(self, is_train, update_aux):
        """The walk: ``(outputs, {name: autograd leaf})``."""
        grads_wanted = is_train and any(
            self.grad_req.get(n, "write") != "null" for n in self.arg_names)
        vals, leaves = {}, {}
        for key, name in self._vars:
            arr = self.arg_dict.get(name)
            if arr is None:
                vals[(key, 0)] = self.aux_dict[name]._data
                continue
            t = arr._data
            if grads_wanted and self.grad_req.get(name, "write") != "null":
                t = leaves[name] = t.detach().requires_grad_()
            vals[(key, 0)] = t
        monitor = self._monitor[0] if self._monitor and self._monitor[1] \
            else None
        with torch.set_grad_enabled(grads_wanted):
            walk(self._plan(is_train), vals, self._device,
                 (lambda n: self.aux_dict[n]._data) if update_aux else None,
                 monitor)
        return [vals[s] for s in self._heads_at], leaves

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` are argument values written into the
        bound arrays first (cast to their dtype, moved to their device).
        Returns the outputs, NDArrays."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise ValueError(f"forward: no argument named {k!r}")
            dst = self.arg_dict[k]
            _write(dst, tensor_like(v, dst._data))
        heads, leaves = self._run(bool(is_train), update_aux=bool(is_train))
        self._heads = (heads, leaves) if leaves else None
        bound = {a._data.untyped_storage().data_ptr()
                 for a in list(self.arg_dict.values())
                 + list(self.aux_dict.values()) if a._data.numel()}
        self._outputs = [
            NDArray(h.detach().clone() if h.numel() and
                    h.untyped_storage().data_ptr() in bound else h.detach())
            for h in heads]
        if self._monitor is not None and not self._monitor[1]:
            for name, val in zip(self.output_names, self._outputs):
                self._monitor[0](name, val)
        return self._outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs into ``grad_dict`` by ``grad_req``.
        ``out_grads`` are the head gradients (ones when ``None``, which
        only a graph of loss heads accepts)."""
        if self._outputs is None:
            raise RuntimeError("backward called before forward")
        if out_grads is None and not self._loss_heads:
            raise ValueError(
                "backward() without out_grads needs every output to be a "
                "loss head (SoftmaxOutput); pass the head gradients")
        if self._heads is None:
            self._heads = self._run(True, update_aux=False)
        heads, leaves = self._heads
        self._heads = None
        if out_grads is None:
            out_grads = [None] * len(heads)
        elif isinstance(out_grads, (NDArray, torch.Tensor)):
            out_grads = [out_grads]
        if len(out_grads) != len(heads):
            raise ValueError(f"{len(heads)} outputs, {len(out_grads)} head "
                             f"gradients")
        pairs = [(h, torch.ones_like(h) if g is None else tensor_like(g, h))
                 for h, g in zip(heads, out_grads) if h.requires_grad]
        names = [n for n in leaves if n in self.grad_dict]
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad([h for h, _ in pairs],
                                        [leaves[n] for n in names],
                                        [g for _, g in pairs],
                                        allow_unused=True)
        with torch.no_grad():
            for name, g in zip(names, grads):
                buf = self.grad_dict[name]._data
                if self.grad_req.get(name, "write") == "add":
                    if g is not None:
                        buf.add_(g)
                elif g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)

    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, NDArray)`` on every output after a forward, or
        with ``monitor_all`` on every node's output during it."""
        self._monitor = None if callback is None else (callback,
                                                       bool(monitor_all))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                dst = self.arg_dict[k]
                _write(dst, tensor_like(v, dst._data))
            elif not allow_extra_params:
                raise ValueError(f"unknown argument {k}")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                dst = self.aux_dict[k]._data
                dst.copy_(tensor_like(v, dst))
            elif not allow_extra_params:
                raise ValueError(f"unknown aux state {k}")
