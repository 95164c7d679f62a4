"""Shared-memory ring buffer of batch slots for the multi-process pipeline.

The reference feeds its iterator pipeline through dmlc ThreadedIter buffers
inside one process; a *multi-process* decode pool needs the same thing across
address spaces.  Each slot is one ``multiprocessing.shared_memory`` segment
sized for one assembled batch: a worker process decodes JPEGs straight into
the slot's pixel area (no pickling, no per-image copies) and the consumer
wraps the filled slot zero-copy as a numpy view, copied once into pinned
memory for ``DevicePrefetchIter``'s staging (or handed out as it is).

Ownership is strictly parent-side: the creating process is the only one that
ever ``unlink``s, registers an ``atexit`` sweep, and recycles slot ids, so
worker crashes can never leak ``/dev/shm`` segments (the ci ``io`` stage
asserts this, including under injected crashes).  Fork-started workers reuse
the parent's already-mapped segments — no attach/re-register dance with the
resource tracker.

The port's copy of ``mxnet_tpu/io/shm_ring.py``: numpy views only, so a
forked worker that fills a slot never calls into torch.
"""
from __future__ import annotations

import atexit
import os
import threading

import numpy as np

from ..telemetry import bus as _tel

__all__ = ["ShmRing"]

_live_rings = []            # rings swept by the atexit hook (parent only)
_live_lock = threading.Lock()


def _atexit_sweep():
    with _live_lock:
        rings = list(_live_rings)
    for ring in rings:
        ring.destroy()


_atexit_registered = False


class ShmRing:
    """A fixed set of equally-sized shared-memory slots.

    The parent creates the ring and hands slot *ids* around; both sides map
    a slot as a numpy array via :meth:`view`.  Free-list bookkeeping lives in
    the parent (:meth:`acquire`/:meth:`release`) — workers receive slot ids
    inside task messages, so there is no cross-process allocator to corrupt.
    """

    def __init__(self, n_slots, slot_bytes, tag="mxt_io"):
        from multiprocessing import shared_memory
        self.n_slots = int(n_slots)
        self.slot_bytes = int(slot_bytes)
        # name carries pid + a counter so a leak is attributable and a CI
        # sweep can grep /dev/shm for the tag
        uid = f"{tag}_{os.getpid()}_{id(self) & 0xffffff:x}"
        self.name = uid
        self._segments = []
        try:
            for i in range(self.n_slots):
                self._segments.append(shared_memory.SharedMemory(
                    create=True, size=self.slot_bytes, name=f"{uid}_{i}"))
        except Exception:
            self.destroy()
            raise
        self._free = list(range(self.n_slots))
        # per-slot recycle generation: bumped on every release, so a
        # zero-copy view can be proven stale (ROADMAP.md item 10 registers
        # such views with a sanitizer, as the JAX package does)
        self._gen = [0] * self.n_slots
        self._destroyed = False
        self._owner_pid = os.getpid()
        global _atexit_registered
        with _live_lock:
            _live_rings.append(self)
            if not _atexit_registered:
                atexit.register(_atexit_sweep)
                _atexit_registered = True

    # ------------------------------------------------------------- parent API
    def acquire(self):
        """Pop a free slot id, or None when the ring is fully in flight."""
        if not self._free:
            return None
        return self._free.pop()

    def release(self, slot_id):
        """Return a slot to the free list (consumer is done with its view).

        Bumps the slot's generation FIRST: any zero-copy view of the old
        generation is stale from this point on — exactly the moment another
        worker may start writing."""
        self._gen[slot_id] += 1
        self._free.append(slot_id)

    def generation(self, slot_id):
        """Recycle count of a slot."""
        return self._gen[slot_id]

    @property
    def in_flight(self):
        """Slots currently filled or being filled — the ring occupancy the
        ``io.shm_ring_occupancy`` gauge reports."""
        return self.n_slots - len(self._free)

    def gauge_occupancy(self):
        if _tel.enabled:
            _tel.gauge("io.shm_ring_occupancy", self.in_flight,
                       slots=self.n_slots)

    # ------------------------------------------------------------ both sides
    def view(self, slot_id, shape, dtype, offset=0):
        """Zero-copy numpy view of (part of) a slot.

        Valid in the parent and in fork-started workers (the mapping is
        inherited).  The view aliases shared memory: it is only stable until
        the slot is released back to the ring and handed to another worker.
        """
        seg = self._segments[slot_id]
        return np.ndarray(shape, dtype=dtype, buffer=seg.buf, offset=offset)

    # --------------------------------------------------------------- teardown
    def destroy(self):
        """Close and unlink every segment (idempotent, parent-owned)."""
        if getattr(self, "_destroyed", False):
            return
        self._destroyed = True
        is_owner = getattr(self, "_owner_pid", None) == os.getpid()
        for seg in self._segments:
            try:
                seg.close()
            except Exception:
                pass
            if is_owner:
                try:
                    seg.unlink()
                except Exception:
                    pass
        self._segments = []
        with _live_lock:
            if self in _live_rings:
                _live_rings.remove(self)

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass
