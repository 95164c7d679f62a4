"""DataLoader (reference ``python/mxnet/gluon/data/dataloader.py``; the
port's counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Batches are host batches, as in MXNet: CPU NDArrays, whatever the current
context, and pinned with ``pin_memory=True`` (when a GPU is visible);
the training loop moves them (``split_and_load``, ``as_in_context``).

``num_workers=0`` loads in the caller's thread.  ``num_workers>0`` loads
in a pool: threads with ``thread_pool=True``, else spawned worker
processes.  A worker is host-only: it runs the dataset and its transforms
on CPU tensors under ``with mx.cpu():`` and returns numpy batches, and the
parent makes the NDArrays.  A worker process runs torch and cv2 on one
thread each, as torch's own ``DataLoader`` workers do.  The workers are
spawned with ``CUDA_VISIBLE_DEVICES`` empty, so a child can never
initialise CUDA (the JAX package pins ``JAX_PLATFORMS=cpu`` for the same
reason).  A spawned worker imports what it unpickles: the dataset's and
the transforms' modules, and the main script (guard its entry point with
``if __name__ == "__main__":``).  Every wait on a worker is bounded by
``timeout`` seconds (MXNet's default 120).
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np

from ... import ndarray as nd
from ...context import cpu
from ...io.io import host_array
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a CPU batch (reference ``dataloader.py:126``)."""
    if isinstance(data[0], NDArray):
        return nd.stack(*[d.as_in_context(cpu()) for d in data])
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    return nd.array(np.asarray(data), ctx=cpu())


def _np_batchify_fn(data):
    """Worker-side batchify: numpy only, so nothing crosses the process
    boundary but plain arrays."""
    if isinstance(data[0], NDArray):
        return np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], tuple):
        data = zip(*data)
        return tuple(_np_batchify_fn(i) for i in data)
    return np.asarray(data)


_worker_dataset = None
_worker_batchify = None


def _worker_init(dataset, batchify_fn, process=False):
    global _worker_dataset, _worker_batchify
    _worker_dataset = dataset
    _worker_batchify = batchify_fn
    # this process's (or thread's) default context is the CPU
    cpu().__enter__()
    if process:
        # one thread each for torch and cv2, as torch's own DataLoader
        # workers run: N workers with a pool of every core each thrash
        # (chip_smoke.py phase 26 on an 8-core H100 host: 34 images/s
        # with 4 such workers, 136 with one thread each)
        import torch
        torch.set_num_threads(1)
        try:
            import cv2
            cv2.setNumThreads(1)
        except ImportError:
            pass


def _worker_fn(samples):
    with cpu():
        return _worker_batchify([_worker_dataset[i] for i in samples])


def _to_host(batch, pin):
    """A worker's batch as CPU NDArrays (pinned when ``pin``)."""
    if isinstance(batch, NDArray):
        return host_array(batch._data) if pin else batch
    if isinstance(batch, np.ndarray):
        return host_array(batch) if pin else nd.array(batch, ctx=cpu())
    if isinstance(batch, (list, tuple)):
        return [_to_host(b, pin) for b in batch]
    return batch


class DataLoader:
    """Loads batches from a Dataset (reference ``dataloader.py:159``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120):
        self._dataset = dataset
        self._pin_memory = bool(pin_memory)
        self._thread_pool = thread_pool
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        if batchify_fn is None:
            self._batchify_fn = default_batchify_fn
            self._worker_batchify = _np_batchify_fn
        else:
            self._batchify_fn = batchify_fn
            self._worker_batchify = batchify_fn
        self._pool = None
        if self._num_workers > 0:
            self._pool = self._make_pool()

    def _make_pool(self):
        args = (self._dataset, self._worker_batchify)
        if self._thread_pool:
            from multiprocessing.pool import ThreadPool
            return ThreadPool(self._num_workers, initializer=_worker_init,
                              initargs=args)
        # spawned children must never see a GPU: hide them through the
        # environment the children inherit at their start
        old = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            ctx = multiprocessing.get_context("spawn")
            return ctx.Pool(self._num_workers, initializer=_worker_init,
                            initargs=args + (True,))
        finally:
            if old is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = old

    def _pinned(self, batch):
        if not self._pin_memory:
            return batch
        batch = _to_host(batch, True)
        return tuple(batch) if isinstance(batch, list) else batch

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                # the scope must not stay open across the yield, where the
                # caller's loop runs
                with cpu():
                    out = self._batchify_fn([self._dataset[i]
                                             for i in batch])
                yield self._pinned(out)
            return
        # pipelined: keep up to `prefetch` batches in flight
        results = []
        it = iter(self._batch_sampler)
        try:
            for _ in range(self._prefetch + 1):
                results.append(self._pool.apply_async(_worker_fn,
                                                       (next(it),)))
        except StopIteration:
            pass
        while results:
            try:
                out = results.pop(0).get(timeout=self._timeout)
            except multiprocessing.TimeoutError:
                raise RuntimeError(
                    f"DataLoader worker produced no batch within "
                    f"{self._timeout} s (a worker died or hangs)") from None
            try:
                results.append(self._pool.apply_async(_worker_fn,
                                                       (next(it),)))
            except StopIteration:
                pass
            batch = _to_host(out, self._pin_memory)
            if isinstance(batch, list):
                batch = tuple(batch)
            yield batch

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
