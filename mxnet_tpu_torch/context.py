"""Device contexts mapped onto torch devices.

Counterpart of ``mxnet_tpu/context.py``.  ``mx.gpu(i)`` means ``cuda:i`` and
``mx.cpu()`` means ``cpu``.  ``with mx.cpu():`` / ``with mx.gpu(0):`` set
the thread's current context, as in MXNet.

One departure from the JAX package: outside any ``with`` scope, the current
context is the GPU, not ``cpu(0)`` (``mxnet_tpu/context.py:124-127``).  So
``mx.nd.array(x)`` with no ``ctx`` lands on ``cuda``, and every entry point
that takes ``device=None`` or ``ctx=None`` means :func:`default_device`;
without a GPU they raise rather than carry on on the CPU.  Tests and CPU
runs ask for the CPU: ``device="cpu"``, ``ctx=mx.cpu()`` or ``with
mx.cpu():``.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "default_device", "as_device"]


class Context:
    """``Context(device_type, device_id)`` as in MXNet; ``torch_device()``
    names the torch device it stands for.  Used in a ``with`` statement it
    is the thread's current context for the block."""

    _scope = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @classmethod
    def from_device(cls, device):
        """The context of a torch device (``cuda`` without an index is the
        current one)."""
        device = torch.device(device)
        if device.type == "cpu":
            return cls("cpu", 0)
        if device.type != "cuda":
            raise ValueError(f"no MXNet context for device {device}")
        return cls("gpu", torch.cuda.current_device()
                   if device.index is None else device.index)

    def torch_device(self):
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        stack = getattr(Context._scope, "stack", None)
        if stack is None:
            stack = Context._scope.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._scope.stack.pop()

    def __eq__(self, other):
        return isinstance(other, Context) and \
            (self.device_type, self.device_id) == \
            (other.device_type, other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    """Number of CUDA devices torch sees."""
    return torch.cuda.device_count()


def default_device():
    """``cuda``; raises when no GPU is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "ctx=mx.cpu()) to run the port's plain path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def current_context():
    """The innermost ``with`` context of this thread, else the GPU (the
    port's default; raises without one)."""
    stack = getattr(Context._scope, "stack", None)
    if stack:
        return stack[-1]
    return Context.from_device(default_device())


def as_device(device=None):
    """``None`` -> the current context's device (:func:`current_context`);
    a :class:`Context`, string or ``torch.device`` -> that torch device."""
    if device is None:
        return current_context().torch_device()
    if isinstance(device, Context):
        return device.torch_device()
    return torch.device(device)
