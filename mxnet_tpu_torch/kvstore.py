"""KVStore: MXNet's key-value parameter store, the single-process types
``local`` and ``device`` (counterpart of ``mxnet_tpu/kvstore.py``).

The store keeps its own copy of every key.  ``push`` sums the values pushed
for a key (one per device; on one device, the one value), then runs the
updater on the store's copy, or, without one, stores the sum; ``pull``
copies the store's value into the given arrays.  ``set_optimizer`` makes
the updater from an optimizer (``Module``'s default, ``update_on_kvstore``):
a push of many keys is then one grouped optimizer update
(``optimizer/aggregate.py``).  A custom updater (``set_updater``) is called
once per key as ``updater(key, merged, stored)`` on NDArrays.

With one device ``local`` and ``device`` are the same store.  The
distributed types (``dist_*``), ``nccl``, gradient compression and
``row_sparse_pull`` are ROADMAP.md queue 1 item 9.
"""
from __future__ import annotations

import numpy as np
import torch

from . import optimizer as opt
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_TYPES = ("local", "device")
_LATER = ("nccl", "local_allreduce_cpu", "local_allreduce_device",
          "dist_sync", "dist_device_sync", "dist_async", "dist_sync_device",
          "dist")


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1 item 9: "
        f"multi-device and distributed training); the port has the "
        f"single-process 'local' and 'device' stores")


def _group_kv(keys, values):
    """(keys, [[values of each key]]) from one key or a list of keys."""
    if not isinstance(keys, (list, tuple)):
        keys, values = [keys], [values]
    if len(keys) != len(values):
        if len(values) % len(keys):
            raise ValueError("unmatched keys/values lengths")
        per = len(values) // len(keys)
        values = [values[i * per:(i + 1) * per] for i in range(len(keys))]
    return list(keys), [[v] if isinstance(v, NDArray) else list(v)
                        for v in values]


class KVStore:
    """An in-process store with MXNet's ``init``/``push``/``pull``."""

    def __init__(self, type_="local"):
        self._type = type_
        self._store = {}
        self._updater = None
        self._str_keys = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def _check_keys(self, keys):
        strs = all(isinstance(k, str) for k in keys)
        if not (strs or all(isinstance(k, (int, np.integer)) for k in keys)):
            raise TypeError("keys must be all int or all str")
        if self._str_keys is None:
            self._str_keys = strs
        elif self._str_keys != strs:
            raise TypeError("mixing int and str keys is not allowed")

    def init(self, key, value):
        """Store a copy of each value under its key."""
        keys, vals = _group_kv(key, value)
        self._check_keys(keys)
        for k, vs in zip(keys, vals):
            if k in self._store:
                raise ValueError(f"duplicate init of key {k}")
            self._store[k] = NDArray(vs[0]._data.detach().clone())

    def push(self, key, value, priority=0):
        """Sum each key's values, then update the store's copy with the
        updater, or store the sum.  ``priority`` is accepted and unused:
        torch orders the work on the stream."""
        keys, vals = _group_kv(key, value)
        self._check_keys(keys)
        merged = []
        for k, vs in zip(keys, vals):
            if k not in self._store:
                raise ValueError(f"key {k} has not been initialized")
            m = vs[0]._data
            for v in vs[1:]:
                m = m + v._data.to(m.device)
            merged.append(m)
        if self._updater is None:
            for k, m in zip(keys, merged):
                self._store[k] = NDArray(m.detach().to(
                    self._store[k]._data.device, copy=True))
        elif isinstance(self._updater, opt.Updater):
            stored = [self._store[k]._data for k in keys]
            merged = [m.to(s.device) for m, s in zip(merged, stored)]
            self._updater(keys, merged, stored)
        else:
            for k, m in zip(keys, merged):
                self._updater(k, NDArray(m), self._store[k])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into its ``out`` array(s)."""
        if out is None:
            raise ValueError("pull needs out")
        keys, outs = _group_kv(key, out)
        self._check_keys(keys)
        with torch.no_grad():
            for k, os_ in zip(keys, outs):
                src = self._store[k]._data
                for o in os_:
                    o._data.copy_(src)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority=priority)
        self.pull(key, value if out is None else out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise _not_ported("row_sparse_pull")

    def set_gradient_compression(self, compression_params):
        raise _not_ported("gradient compression")

    def set_updater(self, updater):
        """``updater(key, merged, stored)`` on NDArrays, run at push."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the store's copies at every push."""
        self._updater = opt.get_updater(optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if not isinstance(self._updater, opt.Updater):
            raise RuntimeError("save_optimizer_states needs an optimizer "
                               "(set_optimizer)")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if not isinstance(self._updater, opt.Updater):
            raise RuntimeError("load_optimizer_states needs an optimizer "
                               "(set_optimizer)")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        """Nothing to wait for in one process."""


def create(name="local"):
    """A store of type ``name``: ``'local'`` or ``'device'``."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    base = name.split("://")[0]
    if base in _LATER:
        raise _not_ported(f"KVStore type {name!r}")
    if base not in _TYPES:
        raise ValueError(f"unknown KVStore type {name!r}")
    return KVStore(name)
