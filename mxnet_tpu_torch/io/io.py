"""Data iterators (the port's counterpart of ``mxnet_tpu/io/io.py``):
``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter``, ``ResizeIter``,
``PrefetchingIter`` and ``DevicePrefetchIter``.

``NDArrayIter`` keeps its data as host numpy arrays and makes each batch an
NDArray on the current context (the GPU unless the caller runs under
``with mx.cpu():``), one host-to-device copy a batch; ``shuffle`` draws from
numpy's global generator, as the JAX package does.

The record and image iterators (``iterators.py``, ``mx.image``) give host
batches, as MXNet's do: CPU NDArrays, in pinned memory when a GPU is
present (:func:`host_array`), which the training loop moves with
``as_in_context`` (a ``non_blocking`` copy from pinned memory).
``DevicePrefetchIter`` moves them one batch ahead on a side CUDA stream.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from .. import ndarray as nd
from ..base import torch_dtype
from ..context import as_device
from ..ndarray import NDArray
from ..ndarray.ndarray import to_device
from ..telemetry import bus as _tel

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "host_array",
           "pinned_empty"]


def pin_host():
    """Whether host batches go to pinned memory: when a GPU is visible.
    A ``DataLoader`` worker sees none (its environment hides the GPUs), so
    it never initialises CUDA."""
    return torch.cuda.is_available()


def pinned_empty(shape, dtype=torch.float32):
    """An uninitialised CPU tensor, pinned when a GPU is visible (from
    torch's caching host allocator, which keeps a block from reuse until
    the copies recorded on it are done)."""
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=pin_host())


def host_array(a, dtype=None):
    """A CPU NDArray holding a copy of ``a`` (a numpy array or a CPU
    tensor), pinned when a GPU is visible; float64 becomes float32, as in
    ``nd.array``."""
    if isinstance(a, torch.Tensor):
        src = a.detach()
        dt = torch_dtype(dtype) if dtype is not None else (
            torch.float32 if src.dtype is torch.float64 else src.dtype)
        out = pinned_empty(src.shape, dt)
        out.copy_(src)
        return NDArray(out)
    a = np.asarray(a)
    dt = torch_dtype(dtype if dtype is not None else (
        np.float32 if a.dtype == np.float64 else a.dtype))
    out = pinned_empty(a.shape, dt)
    out.numpy()[...] = a
    return NDArray(out)


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name/shape/type descriptor (reference ``io.py:68``)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        """Axis of the batch dimension in ``layout`` (reference ``io.py:118``)."""
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference ``io.py:146``)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Iterator base (reference ``io.py:212``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch (reference
    ``io.py:308``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Normalize data into an OrderedDict of name→np.ndarray (reference
    ``io.py:574 _init_data``)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict(
                [("_%d_%s" % (i, default_name), d) for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = OrderedDict()
    for k, v in data.items():
        if isinstance(v, NDArray):
            out[k] = v.asnumpy()
        else:
            out[k] = np.asarray(v)
    return list(out.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference ``io.py:623``), with
    ``shuffle`` and MXNet 1.5's ``last_batch_handle``: ``'pad'`` fills the
    last batch from the start of the data (``pad`` counts the filler
    rows), ``'discard'`` drops an incomplete last batch, ``'roll_over'``
    keeps it for the next epoch, whose first batch is those rows followed
    by the first of the data (``pad`` counts the rows carried over).

    The JAX package's ``roll_over`` returns the incomplete batch padded
    and starts the next epoch with a short batch; the port follows the
    reference (ROADMAP.md, reference-side defects)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError(f"last_batch_handle must be 'pad', 'discard' "
                             f"or 'roll_over', got {last_batch_handle!r}")
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._cache = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        """Start over, dropping a carried-over batch."""
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        if self.last_batch_handle == "roll_over" and \
                self.num_data - self.batch_size < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def _shuffle_data(self):
        perm = np.random.permutation(self.num_data)
        self.data = [(k, v[perm]) for k, v in self.data]
        self.label = [(k, v[perm]) for k, v in self.label]

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        rows = self._rows()
        if self.cursor < 0:
            self._cache = None           # the carried-over rows are used
        if len(rows[0]) != self.batch_size:
            # an incomplete last batch: dropped, or kept for the next epoch
            if self.last_batch_handle == "roll_over":
                self._cache = rows
            raise StopIteration
        nd_data = [nd.array(r) for r in rows[:len(self.data)]]
        nd_label = [nd.array(r) for r in rows[len(self.data):]]
        return DataBatch(data=nd_data, label=nd_label, pad=self.getpad(),
                         index=None)

    def _rows(self):
        """The numpy rows of the batch at the cursor, data then labels."""
        sources = [v for _, v in self.data] + [v for _, v in self.label]
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            if self._cache is None:
                raise RuntimeError("roll_over: no batch carried over from "
                                   "the last epoch")
            return [np.concatenate([c, v[:self.cursor + self.batch_size]])
                    for c, v in zip(self._cache, sources)]
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return [np.concatenate([v[self.cursor:],
                                    v[:end - self.num_data]])
                    for v in sources]
        return [v[self.cursor:min(end, self.num_data)] for v in sources]

    def getdata(self):
        return [nd.array(r) for r in self._rows()[:len(self.data)]]

    def getlabel(self):
        return [nd.array(r) for r in self._rows()[len(self.data):]]

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            return -self.cursor
        return 0


class PrefetchingIter(DataIter):
    """Thread-backed prefetcher over one or more iterators (reference
    ``io.py:381``, ``mxnet_tpu/io/io.py:157``; the dmlc ThreadedIter
    double-buffering role).  A worker's exception is re-raised on the
    consumer's thread, sticky; every wait is bounded, so a worker that died
    without one raises instead of hanging."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        self.worker_exc = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                # producer wait: blocked on the consumer taking the last
                # batch; the shutdown wake-up is not a stall
                t0 = time.perf_counter()
                self.data_taken[i].wait()
                if not self.started:
                    break
                if _tel.enabled:
                    _tel.count("io.producer_wait_ms",
                               (time.perf_counter() - t0) * 1e3)
                try:
                    with _tel.span("io.produce_batch", iter=i):
                        self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                except BaseException as e:
                    # parked for the consumer; this worker stops
                    self.worker_exc[i] = e
                    self.next_batch[i] = None
                    if _tel.enabled:
                        _tel.count("io.worker_error", stage="prefetch")
                    self.data_taken[i].clear()
                    self.data_ready[i].set()
                    return
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i], daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()
        for thread in self.prefetch_threads:
            thread.join(timeout=1.0)

    def _renamed(self, attr, renames):
        if renames is None:
            return sum([getattr(i, attr) for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(r[x[0]], x[1])
                     for x in getattr(i, attr)]
                    for r, i in zip(renames, self.iters)], [])

    @property
    def provide_data(self):
        return self._renamed("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._renamed("provide_label", self.rename_label)

    def _wait_ready(self, i, e):
        while not e.wait(timeout=1.0):
            if self.worker_exc[i] is not None:
                raise self.worker_exc[i]
            if not self.prefetch_threads[i].is_alive():
                raise RuntimeError(
                    f"PrefetchingIter worker {i} died without producing a "
                    f"batch or an exception")

    def reset(self):
        for i, e in enumerate(self.data_ready):
            if self.worker_exc[i] is None:
                self._wait_ready(i, e)
            if self.worker_exc[i] is not None:
                raise self.worker_exc[i]
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        # consumer wait: the training loop blocked on decode
        t0 = time.perf_counter()
        for i, e in enumerate(self.data_ready):
            self._wait_ready(i, e)
        for exc in self.worker_exc:
            if exc is not None:
                raise exc               # sticky: the worker is gone
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, "Number of entry mismatches between iterators"
            return False
        if _tel.enabled:
            _tel.count("io.consumer_wait_ms",
                       (time.perf_counter() - t0) * 1e3)
            _tel.count("io.batches")
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Different pad size between iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], [])
            if self.next_batch[0].label is not None else None,
            self.next_batch[0].pad,
            self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


_AUGMENT_ATTRS = ("augment_flip", "augment_crop")


class _Stager:
    """Host batches to ``device``, one batch ahead of the consumer.

    On a CUDA device each array is copied with :func:`to_device` on a side
    stream (``non_blocking`` from pinned memory), an event is recorded
    after the copies, and the staging thread waits for that event before
    it returns.  So the caller's host arrays may change as soon as
    ``stage`` returns, a source that refills one buffer included, while
    the copy still overlaps the consumer's work on the card.  On the CPU
    the copies are synchronous and there is no event."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def stage(self, tensors):
        if self.stream is None:
            return [to_device(t, self.device) for t in tensors], None
        with torch.cuda.stream(self.stream):
            out = [to_device(t, self.device) for t in tensors]
            event = torch.cuda.Event()
            event.record(self.stream)
        event.synchronize()
        return out, event

    def stage_batch(self, batch):
        """A :class:`DataBatch` of host NDArrays -> (the batch on the
        device, the copies' event)."""
        data = list(batch.data)
        label = list(batch.label or [])
        out, event = self.stage([d._data for d in data + label])
        staged = DataBatch([NDArray(t) for t in out[:len(data)]],
                           [NDArray(t) for t in out[len(data):]]
                           if batch.label is not None else None,
                           pad=batch.pad, index=batch.index,
                           provide_data=getattr(batch, "provide_data", None),
                           provide_label=getattr(batch, "provide_label",
                                                 None))
        for attr in _AUGMENT_ATTRS:
            if hasattr(batch, attr):
                setattr(staged, attr, getattr(batch, attr))
        return staged, event


def _tensors_of(obj):
    if isinstance(obj, NDArray):
        return [obj._data]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, DataBatch):
        return [t for part in (obj.data, obj.label or [])
                for x in part for t in _tensors_of(x)]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors_of(x)]
    return []


class DevicePrefetchIter:
    """Double-buffered host-to-device staging (``mxnet_tpu/io/io.py:459``;
    the ``iter_prefetcher.h`` role): a background thread pulls host batches
    from ``data_iter`` and stages them one ahead, so batch N+1 crosses to
    the card while the card steps batch N.

    With no ``stage_fn`` the thread moves each batch's arrays to ``ctx``
    (the current context, the GPU by default) through :class:`_Stager`:
    ``non_blocking`` copies from pinned memory on a side stream and an
    event, which the staging thread waits for.  The consumer's stream waits
    on that event before the batch is handed out, and each tensor is
    marked used on the consumer's stream (``record_stream``), so the
    caching allocator keeps it until the consumer's work on it is done.
    On the CPU the staging is synchronous.

    ``stage_fn(batch) -> payload`` replaces the default; it runs on the
    prefetch thread, and the iterator yields its payloads in order.
    ``depth`` bounds the staged batches in flight (2 = double buffer).
    """

    _END = object()

    def __init__(self, data_iter, stage_fn=None, depth=2, ctx=None):
        self._it = data_iter
        self._depth = max(1, int(depth))
        self._q = queue.Queue(maxsize=self._depth)
        self._device = as_device(ctx) if stage_fn is None else None
        self._stager = _Stager(self._device) if stage_fn is None else None
        self._stage = stage_fn
        self._thread = None
        self._stop = False
        self._done = False        # epoch ended (or errored): next raises

    def _stage_one(self, batch):
        if self._stage is not None:
            return self._stage(batch), None
        return self._stager.stage_batch(batch)

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop:
                    return
                with _tel.span("io.stage_batch"):
                    item = self._stage_one(batch)
                t0 = time.perf_counter()
                self._q.put(item)
                if _tel.enabled:
                    # blocked on a full queue: the device is the slow side
                    _tel.count("io.producer_wait_ms",
                               (time.perf_counter() - t0) * 1e3)
                if self._stop:
                    return
            self._q.put(self._END)
        except BaseException as e:          # surfaced on the consumer side
            if _tel.enabled:
                _tel.count("io.worker_error", stage="stage")
            self._q.put(e)

    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        old = self._thread
        if old is not None and old.is_alive():
            self._stop = True
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            old.join(timeout=30.0)
            if old.is_alive():
                raise RuntimeError(
                    "DevicePrefetchIter.reset: the staging thread is still "
                    "inside its stage after 30s; cannot safely reset the "
                    "underlying iterator")
        self._stop = False
        self._done = False
        while not self._q.empty():
            self._q.get_nowait()
        self._it.reset()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mxio-device-prefetch")
        self._thread.start()

    def __next__(self):
        if self._thread is None:
            self.reset()
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            # bounded gets: a staging thread that died without queueing its
            # exception must surface here, not hang the training loop
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        self._done = True
                        raise RuntimeError(
                            "DevicePrefetchIter staging thread died "
                            "without a result") from None
        if item is self._END:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        payload, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _tensors_of(payload):
                t.record_stream(consumer)
        if _tel.enabled:
            # blocked on an empty queue: staging/decode is the slow side
            _tel.count("io.consumer_wait_ms",
                       (time.perf_counter() - t0) * 1e3)
            _tel.count("io.batches")
        return payload

    next = __next__
