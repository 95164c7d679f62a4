"""MXNet's autograd API on ``torch.autograd`` (counterpart of
``mxnet_tpu/autograd.py``).

Scopes.  ``record()``/``pause()`` and ``train_mode()``/``predict_mode()``
set two thread-local flags, as MXNet's imperative runtime does.  Recording
is torch's grad mode: ``record()`` switches it on and ``pause()`` off for
the scope, and a ``HybridBlock`` called outside ``record()`` runs under
``torch.no_grad()``, so that, as in MXNet, nothing outside ``record()``
builds a graph.  The training flag is what ``BatchNorm`` and ``Dropout``
read (``is_training()``), not ``nn.Module.training``.

Gradients.  A tensor's gradient buffer is its ``.grad``.
``mark_variables`` attaches a buffer and a ``grad_req``: ``'write'``
overwrites the buffer on every ``backward``, ``'add'`` accumulates into it,
``'null'`` takes no gradient.  A leaf that requires grad and was never
marked (a block's parameter) behaves as ``'write'``.  ``backward`` finds
the leaves of the heads' graph, takes their gradients with
``torch.autograd.grad`` and writes each into its buffer by its
``grad_req``; with no head gradients it uses ones, as MXNet does, so a
per-sample loss vector needs no ``sum()``.

NDArrays.  Every function here takes ``mx.nd`` NDArrays wherever it takes
tensors (heads, head gradients, variables and their buffers) and works on
the tensors they hold; ``grad`` returns NDArrays for NDArray variables.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_GRAD_REQS = ("write", "add", "null")
# attribute of a marked tensor that holds its grad_req
_REQ_ATTR = "_mx_grad_req"

_state = threading.local()


def is_recording():
    return getattr(_state, "recording", False)


def is_training():
    return getattr(_state, "training", False)


def set_recording(flag):
    """Set the recording flag and torch's grad mode; returns the previous
    flag."""
    prev = is_recording()
    _state.recording = bool(flag)
    torch.set_grad_enabled(bool(flag))
    return prev


def set_training(flag):
    """Set the training flag; returns the previous one."""
    prev = is_training()
    _state.training = bool(flag)
    return prev


class _Scope:
    def __init__(self, recording=None, training=None):
        self._rec, self._train = recording, training

    def __enter__(self):
        if self._rec is not None:
            self._prev_grad = torch.is_grad_enabled()
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            _state.recording = self._prev_rec
            torch.set_grad_enabled(self._prev_grad)
        if self._train is not None:
            set_training(self._prev_train)


def record(train_mode=True):
    """``with autograd.record():`` records a graph (training mode by
    default)."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode=False):
    """Stops recording inside a ``record()`` scope."""
    return _Scope(recording=False, training=train_mode)


def train_mode():
    return _Scope(training=True)


def predict_mode():
    return _Scope(training=False)


def _check_grad_req(req):
    if req not in _GRAD_REQS:
        raise ValueError(f"grad_req must be one of {_GRAD_REQS}, got {req!r}")


def _set_grad_req(tensor, req):
    _check_grad_req(req)
    tensor.requires_grad_(req != "null")
    setattr(tensor, _REQ_ATTR, req)


def grad_req_of(tensor):
    """The ``grad_req`` ``backward`` applies to a leaf tensor."""
    if not tensor.requires_grad:
        return "null"
    return getattr(tensor, _REQ_ATTR, "write")


def _is_array(x):
    return isinstance(x, torch.Tensor) or isinstance(
        getattr(x, "_data", None), torch.Tensor)


def _tensor(x):
    """The tensor an NDArray holds; a tensor (or ``None``) as it is."""
    return x if x is None or isinstance(x, torch.Tensor) else x._data


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each leaf tensor a variable whose gradient ``backward`` writes
    into the matching buffer (``mxnet_tpu/autograd.py:128``)."""
    if _is_array(variables):
        variables, gradients = [variables], [gradients]
    variables = [_tensor(v) for v in variables]
    gradients = [_tensor(g) for g in gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    if not len(variables) == len(gradients) == len(grad_reqs):
        raise ValueError("variables, gradients and grad_reqs differ in "
                         "length")
    for v, g, req in zip(variables, gradients, grad_reqs):
        _set_grad_req(v, req)
        v.grad = g


def _as_list(x):
    """Tensors of one array or of a list of them."""
    return [_tensor(x)] if _is_array(x) else [_tensor(a) for a in x]


def _head_grads(heads, head_grads):
    if head_grads is None:
        return [torch.ones_like(h) for h in heads]
    head_grads = _as_list(head_grads)
    if len(head_grads) != len(heads):
        raise ValueError(f"{len(heads)} heads, {len(head_grads)} head "
                         f"gradients")
    return [torch.ones_like(h) if g is None else g
            for h, g in zip(heads, head_grads)]


def _leaves(heads):
    """Leaf tensors that require grad under ``heads``, by a walk over
    their autograd graph."""
    leaves, seen, stack = {}, set(), []
    for h in heads:
        if not h.requires_grad:
            raise ValueError(
                "cannot differentiate: a head was not computed inside "
                "autograd.record() from tensors that take a gradient")
        if h.grad_fn is None:
            leaves[id(h)] = h
        else:
            stack.append(h.grad_fn)
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        variable = getattr(fn, "variable", None)   # AccumulateGrad
        if variable is not None:
            leaves[id(variable)] = variable
            continue
        stack.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    return list(leaves.values())


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Gradients of ``heads`` into the buffers of the leaves under them
    (``mxnet_tpu/autograd.py:196``), each by its ``grad_req``.
    ``create_graph`` records the gradient computation: each buffer then
    holds a gradient that can be differentiated again (the buffer is
    rebound to it, as the JAX package rebinds its NDArray), and the graph
    of ``heads`` is kept."""
    heads = _as_list(heads)
    hgrads = _head_grads(heads, head_grads)
    leaves = [v for v in _leaves(heads) if grad_req_of(v) != "null"]
    if not leaves:
        return
    with _Scope(recording=create_graph, training=train_mode):
        grads = torch.autograd.grad(heads, leaves, hgrads,
                                    retain_graph=retain_graph or create_graph,
                                    create_graph=create_graph,
                                    allow_unused=True)
    for v, g in zip(leaves, grads):
        if g is None:
            continue
        add = grad_req_of(v) == "add" and v.grad is not None
        if create_graph:
            v.grad = v.grad + g if add else g
            continue
        with torch.no_grad():
            if v.grad is None or v.grad.requires_grad:
                # a fresh buffer: ``g`` may be a view or shared with
                # another leaf's gradient, and a recorded gradient is
                # rebound, not written
                v.grad = (v.grad.detach() + g) if add else \
                    torch.empty_like(v).copy_(g)
            elif add:
                v.grad.add_(g)
            else:
                v.grad.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned, not
    written to any buffer (``mxnet_tpu/autograd.py:351``).  A variable the
    heads do not reach gets zeros.  ``create_graph`` records the gradient
    computation, so that it can be differentiated again."""
    single = _is_array(variables)
    wrap = not isinstance(variables if single else variables[0],
                          torch.Tensor)
    variables = _as_list(variables)
    heads = _as_list(heads)
    for v in variables:
        if not v.requires_grad:
            raise ValueError("variables passed to autograd.grad must take "
                             "a gradient (mark_variables)")
    hgrads = _head_grads(heads, head_grads)
    retain = create_graph if retain_graph is None else retain_graph
    with _Scope(recording=create_graph, training=train_mode):
        grads = torch.autograd.grad(heads, variables, hgrads,
                                    retain_graph=retain,
                                    create_graph=create_graph,
                                    allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(variables, grads)]
    if wrap:
        from .ndarray import NDArray
        grads = [NDArray(g) for g in grads]
    return grads[0] if single else grads


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function`'s forward and backward as a node of torch's
    graph."""

    @staticmethod
    def forward(ctx, func, *inputs):
        ctx.func = func
        with pause():
            outputs = func.forward(*inputs)
        return tuple(outputs) if isinstance(outputs, list) else outputs

    @staticmethod
    def backward(ctx, *output_grads):
        with pause():
            input_grads = ctx.func.backward(*output_grads)
        if isinstance(input_grads, torch.Tensor):
            input_grads = (input_grads,)
        return (None, *input_grads)


class Function:
    """A differentiable function with a hand-written backward
    (``mxnet_tpu/autograd.py:385``): subclass, define ``forward(*inputs)``
    and ``backward(*output_grads)``, call an instance.  Both run outside
    recording."""

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensors(self):
        return getattr(self, "_saved", ())

    def __call__(self, *inputs):
        outputs = _Bridge.apply(self, *inputs)
        return list(outputs) if isinstance(outputs, tuple) else outputs
