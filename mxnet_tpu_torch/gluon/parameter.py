"""Gluon ``Parameter`` (counterpart of ``mxnet_tpu/gluon/parameter.py``, the
part training needs).

A ``Parameter`` is a named tensor with the settings a ``Trainer`` reads:
``grad_req`` (``'write'``, ``'add'`` or ``'null'``), ``lr_mult`` and
``wd_mult``.  Blocks keep their weights as ``nn.Parameter``s and buffers;
``HybridBlock.collect_params`` wraps each in one ``Parameter``, made once
and kept on the tensor, so that settings made through one
``collect_params()`` hold in the next.  The gradient buffer is the tensor's
``.grad`` (``autograd.py``); it reads zeros until a ``backward`` writes it.

The tensor holds its ``Parameter`` and the ``Parameter`` holds a block's
tensor weakly, so the two make no reference cycle: dropping a block (and
its Trainer and optimizer states) frees its memory at once, without the
cyclic collector.  A ``Parameter`` whose block is gone raises on use.  A
standalone ``Parameter`` owns the tensor :meth:`Parameter.initialize`
makes.
"""
from __future__ import annotations

import weakref

import torch

from .. import autograd
from ..base import torch_dtype
from ..context import as_device
from ..initializer import Uniform

__all__ = ["Parameter"]

# attribute of a block's tensor that holds its Parameter
_PARAM_ATTR = "_mx_param"
_CONSTANT_INITS = {"zeros": 0.0, "ones": 1.0}


class Parameter:
    """A named tensor with Gluon's gradient and optimizer settings
    (``mxnet_tpu/gluon/parameter.py:37``).  A standalone one takes its
    tensor from :meth:`initialize`."""

    def __init__(self, name, grad_req="write", shape=None,
                 dtype=torch.float32, lr_mult=1.0, wd_mult=1.0, init=None):
        self.name = name
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._shape = (shape,) if isinstance(shape, int) else shape
        self._dtype = dtype
        self._owned = None           # the tensor of a standalone Parameter
        self._ref = None             # a weak reference to a block's tensor
        autograd._check_grad_req(grad_req)
        self._grad_req = grad_req

    @classmethod
    def of(cls, name, tensor):
        """The ``Parameter`` of a block's tensor, made on first use: a
        buffer, or a weight that takes no gradient, has ``grad_req='null'``.
        """
        param = getattr(tensor, _PARAM_ATTR, None)
        if param is None:
            param = cls(name, autograd.grad_req_of(tensor),
                        dtype=tensor.dtype)
            param._ref = weakref.ref(tensor)
            setattr(tensor, _PARAM_ATTR, param)
        return param

    @property
    def _data(self):
        """The tensor; ``None`` before :meth:`initialize`.  Raises when the
        block that owned it is gone."""
        if self._ref is None:
            return self._owned
        tensor = self._ref()
        if tensor is None:
            raise RuntimeError(f"Parameter {self.name!r} belongs to a block "
                               f"that has been freed; collect_params() of a "
                               f"live block gives its parameters")
        return tensor

    def __repr__(self):
        return f"Parameter {self.name} (grad_req={self.grad_req})"

    @property
    def grad_req(self):
        if self._data is None:
            return self._grad_req
        return autograd.grad_req_of(self._data)

    @grad_req.setter
    def grad_req(self, req):
        autograd._check_grad_req(req)
        self._grad_req = req
        if self._data is not None:
            autograd._set_grad_req(self._data, req)
            if req == "null":
                self._data.grad = None

    def initialize(self, init=None, device=None, generator=None):
        """Make the tensor on ``device`` (the GPU by default) and fill it:
        ``init`` is ``'zeros'``, ``'ones'`` or an initializer called as
        ``init(name, tensor, generator)`` (default :class:`Uniform`)."""
        if self._shape is None or 0 in self._shape:
            raise ValueError(f"Parameter {self.name!r} has no shape "
                             f"({self._shape})")
        init = self.init if init is None else init
        data = torch.empty(self._shape, dtype=self._dtype,
                           device=as_device(device))
        with torch.no_grad():
            if isinstance(init, str):
                data.fill_(_CONSTANT_INITS[init])
            else:
                (Uniform() if init is None else init)(self.name, data,
                                                      generator)
        autograd._set_grad_req(data, self._grad_req)
        self._owned, self._ref = data, None

    def _check(self):
        if self._data is None:
            raise RuntimeError(f"Parameter {self.name!r} has not been "
                               f"initialized")
        return self._data

    def data(self):
        """The tensor itself: a leaf that takes a gradient unless
        ``grad_req='null'``."""
        return self._check()

    def grad(self):
        """The gradient buffer (zeros until a ``backward`` reaches it)."""
        data = self._check()
        if self.grad_req == "null":
            raise RuntimeError(f"Cannot get gradient array for Parameter "
                               f"{self.name!r} because grad_req='null'")
        if data.grad is None:
            data.grad = torch.zeros_like(data)
        return data.grad

    def zero_grad(self):
        """Zero the gradient buffer in place."""
        data = self._check()
        if data.grad is not None:
            data.grad.zero_()

    def cast(self, dtype):
        """Cast the value and its gradient buffer to ``dtype`` in place of
        the old ones (``mxnet_tpu/gluon/parameter.py:425``); the tensor
        object, and so the block's attribute, stays the same."""
        self._dtype = torch_dtype(dtype)
        t = self._data
        if t is None:
            return
        with torch.no_grad():
            t.data = t.data.to(self._dtype)
            if t.grad is not None:
                t.grad = t.grad.to(self._dtype)

    def set_data(self, value):
        """Overwrite the value in place, keeping the tensor."""
        with torch.no_grad():
            self._check().copy_(torch.as_tensor(value))
