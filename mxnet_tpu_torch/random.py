"""Seeded random state: one ``torch.Generator`` per device (the port's
counterpart of ``mxnet_tpu/random.py``).

The JAX package splits a process-global ``jax.random`` key per stochastic
op.  Here each device has an explicit generator, made on first use from the
last seed; ``ndarray/register.py`` hands the generator of the op's device to
every stochastic op (``ops/random_ops.py``, ``Dropout``).  The bits differ
from the JAX package's, so the two are held to each other by distribution.

:func:`seed` resets every device's generator and also seeds torch's default
generators (``torch.manual_seed``), which ``gluon.nn.Dropout``
(``F.dropout``) and the initializers draw from when given no generator.
The sampling functions (``mx.random.uniform`` ...) are ``mx.nd.random``'s,
installed by the package.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_state = {"seed": 0, "generators": {}}


def seed(seed_state, ctx="all"):
    """Reset the generators (``mx.random.seed``): every device's, or with
    ``ctx`` one device's only."""
    s = int(seed_state)
    with _lock:
        if ctx == "all":
            _state["seed"] = s
            _state["generators"].clear()
            torch.manual_seed(s)
            return
        from .context import as_device
        device = as_device(ctx)
        _state["generators"][device] = _make(device, s)


def _make(device, s):
    return torch.Generator(device=device).manual_seed(s)


def generator(device):
    """The generator of ``device`` (a torch device), made from the last seed
    on first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _state["generators"].get(device)
        if gen is None:
            gen = _state["generators"][device] = _make(device,
                                                       _state["seed"])
        return gen
