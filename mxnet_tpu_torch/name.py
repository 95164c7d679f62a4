"""Automatic naming (counterpart of ``mxnet_tpu/name.py``; MXNet's
``python/mxnet/name.py``): a ``NameManager`` gives names like ``dense0``
from per-hint counters, ``Prefix`` puts a prefix before each, and
``current()`` is the thread's active manager.

Gluon blocks made outside any ``name_scope`` take their prefix from the
current manager (``gluon/block.py``), so the counters depend on how many
blocks of a kind the thread has made.  A fresh ``with NameManager():``
starts every counter at 0.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """Assigns unique names like ``dense0`` per type hint
    (``mxnet_tpu/name.py:8``); used in a ``with`` statement it is the
    thread's current manager for the block."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """``name`` if given, else ``hint`` and its next count."""
        if name:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}"

    def __enter__(self):
        self._old_manager = current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """Puts ``prefix`` before every name it gives (``mxnet_tpu/name.py:41``).
    """

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    """The thread's active manager (a root one is made on first use)."""
    manager = getattr(NameManager._current, "value", None)
    if manager is None:
        manager = NameManager._current.value = NameManager()
    return manager
