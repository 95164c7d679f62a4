"""Dataset iterators (the port's copy of ``mxnet_tpu/io/iterators.py``, the
``src/io/`` layer rebuilt in Python): ``CSVIter``, ``MNISTIter``,
``LibSVMIter``, ``ImageRecordIter`` and ``ImageDetRecordIter``.

Batches are host batches, as MXNet's iterators give them: CPU NDArrays,
pinned when a GPU is visible (``io.host_array``), which the training loop
moves with ``as_in_context`` or a :class:`~.io.DevicePrefetchIter`.  They
read local files only.

``ImageRecordIter`` reads records with the native reader and decodes with
the native libjpeg decoder when ``_native`` built them, else with Python IO
and cv2; ``reader`` and ``decoder`` say which (and why).  Its thread path
decodes a batch in one native call (or on a thread pool through cv2), its
process path (``preprocess_processes=N``) in N forked workers that fill
shared-memory slots (``pipeline.py``), with the same record order and the
same random stream, so both give the same bits.  ``device_augment=True``
leaves the crop, mirror and normalisation to :attr:`augmenter`, the
device prologue (``image.DeviceAugmenter``): workers decode to a uint8
canvas and the batch carries ``augment_flip``/``augment_crop``.

Not ported here: the fault-injection sites and the
``MXNET_SANITIZE=slots`` registration of zero-copy views (ROADMAP.md
item 10).
"""
from __future__ import annotations

import gzip
import os
import struct
import time

import numpy as np
import torch

from ..base import parse_tuple
from ..ndarray import NDArray
from ..telemetry import bus as _tel
from .io import DataBatch, DataDesc, DataIter, host_array, pinned_empty

__all__ = ["CSVIter", "MNISTIter", "ImageRecordIter", "LibSVMIter",
           "ImageDetRecordIter"]


def _maybe_parse_shape(s):
    if isinstance(s, str):
        return parse_tuple(s)
    return tuple(int(x) for x in s)


class _ArrayBackedIter(DataIter):
    """Shared epoch logic over materialized (data, label) numpy arrays."""

    def __init__(self, data, label, batch_size, shuffle=False,
                 round_batch=True, data_name="data", label_name="label",
                 part_index=0, num_parts=1, dtype="float32", seed=0):
        super().__init__(int(batch_size))
        if num_parts > 1:
            # worker sharding (reference kParts handling in iter_csv.cc /
            # iter_image_recordio_2.cc): contiguous split by part index
            n = data.shape[0]
            per = (n + num_parts - 1) // num_parts
            sl = slice(part_index * per, min(n, (part_index + 1) * per))
            data, label = data[sl], label[sl]
        self._data = data.astype(dtype, copy=False)
        self._label = label
        self._shuffle = bool(shuffle)
        self._round_batch = bool(round_batch)
        self._data_name = data_name
        self._label_name = label_name
        self._rng = np.random.RandomState(seed)
        self.num_data = self._data.shape[0]
        assert self.num_data >= self.batch_size, \
            "batch_size larger than dataset"
        self._order = np.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data.shape[1:],
                         self._data.dtype)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size,) + self._label.shape[1:],
                         self._label.dtype)]

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = -self.batch_size

    def iter_next(self):
        self._cursor += self.batch_size
        if self._round_batch:
            return self._cursor < self.num_data
        return self._cursor + self.batch_size <= self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        start = self._cursor
        end = start + self.batch_size
        if end <= self.num_data:
            sel = self._order[start:end]
            pad = 0
        else:
            pad = end - self.num_data
            sel = np.concatenate([self._order[start:], self._order[:pad]])
        return DataBatch(data=[host_array(self._data[sel])],
                         label=[host_array(self._label[sel])], pad=pad,
                         index=sel.copy())

    def getpad(self):
        end = self._cursor + self.batch_size
        return max(0, end - self.num_data)


class CSVIter(_ArrayBackedIter):
    """Reference ``src/io/iter_csv.cc:218`` — dense CSV reader."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, shuffle=False,
                 dtype="float32", **kwargs):
        data_shape = _maybe_parse_shape(data_shape)
        label_shape = _maybe_parse_shape(label_shape)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + data_shape)
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + label_shape)
        else:
            label = np.zeros((data.shape[0],) + label_shape, dtype=np.float32)
        super().__init__(data, label, batch_size, shuffle=shuffle,
                         round_batch=round_batch, dtype=dtype,
                         label_name="label", **kwargs)


def _read_idx_file(path):
    """IDX (MNIST) format: big-endian magic, dims, payload. Handles .gz."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    magic = struct.unpack(">I", raw[:4])[0]
    dtype_code = (magic >> 8) & 0xFF
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
    dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32,
              0x0D: np.float32, 0x0E: np.float64}
    data = np.frombuffer(raw[4 + 4 * ndim:], dtype=dtypes[dtype_code])
    return data.reshape(dims)


class MNISTIter(_ArrayBackedIter):
    """Reference ``src/io/iter_mnist.cc:260`` — raw MNIST idx files."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0, **kwargs):
        images = _read_idx_file(image).astype(np.float32) / 255.0
        labels = _read_idx_file(label).astype(np.float32)
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1,
                                    images.shape[1], images.shape[2])
        super().__init__(images, labels, batch_size, shuffle=shuffle,
                         data_name="data", label_name="softmax_label",
                         seed=seed, **kwargs)
        if not silent:
            import logging
            logging.info("MNISTIter: load %d images", images.shape[0])


class LibSVMIter(_ArrayBackedIter):
    """Reference ``src/io/iter_libsvm.cc:200`` — libsvm sparse text; rows are
    densified, as in the JAX package (the port stores dense arrays only)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        data_shape = _maybe_parse_shape(data_shape)
        n_feat = int(np.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(n_feat, dtype=np.float32)
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    row[int(i)] = float(v)
                rows.append(row)
        data = np.stack(rows).reshape((-1,) + data_shape)
        label = np.asarray(labels, dtype=np.float32)
        if label_libsvm is not None:
            lab_rows = []
            with open(label_libsvm) as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        lab_rows.append(float(parts[0]))
            label = np.asarray(lab_rows, dtype=np.float32)
        super().__init__(data, label, batch_size, round_batch=round_batch,
                         **kwargs)


class ImageRecordIter(DataIter):
    """Reference ``src/io/iter_image_recordio_2.cc`` — RecordIO images with
    decode + augmentation (``mxnet_tpu/io/iterators.py:205``).

    Augmenters of ``src/io/image_aug_default.cc``: resize (shorter edge),
    centre or random crop, random mirror, mean/std normalisation, scale.
    Flips and crop fractions come from ``np.random.RandomState(seed)``, in
    the JAX package's order, so at the same seed and with the same decoder
    the two packages give the same batches.

    ``preprocess_processes=N`` (N>0) decodes in N forked worker processes
    into a shared-memory ring (``pipeline.py``); each batch is copied out
    of its slot once, into pinned memory.  ``zero_copy_batches=True``
    hands out the slot itself (a CPU NDArray over shared memory), stable
    only until the following ``next()``/``reset()`` — MXNet's buffer-reuse
    contract.  ``pipeline_timeout`` bounds every wait on a worker.

    ``reader`` is ``"native"`` (``src/io/recordio_reader.cc``) or
    ``"python (<reason>)"``; ``decoder`` is ``"native"``
    (``src/io/jpeg_decode.cc``) or ``"cv2 (<reason>)"``.
    """

    def __init__(self, path_imgrec, data_shape, batch_size=1,
                 path_imgidx=None, shuffle=False, round_batch=True,
                 resize=-1, rand_crop=False, rand_mirror=False,
                 mean_img=None, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 preprocess_threads=4, preprocess_processes=0,
                 device_augment=False, shard=None, ring_slots=None,
                 worker_respawn=False, pipeline_timeout=None,
                 zero_copy_batches=False,
                 seed=0, part_index=0, num_parts=1,
                 label_width=1, dtype="float32", **kwargs):
        super().__init__(int(batch_size))
        from .. import _native, recordio
        from . import pipeline as _pl
        if shard is not None:
            num_parts, part_index = shard.num_parts, shard.part_index
        self._data_shape = _maybe_parse_shape(data_shape)
        assert len(self._data_shape) == 3, "data_shape must be (C, H, W)"
        self._resize = int(resize)
        self._rand_crop = bool(rand_crop)
        self._rand_mirror = bool(rand_mirror)
        self._mean = np.array([mean_r, mean_g, mean_b], dtype=np.float32)
        self._std = np.array([std_r, std_g, std_b], dtype=np.float32)
        self._scale = float(scale)
        self._dtype = dtype
        self._label_width = int(label_width)
        self._rng = np.random.RandomState(seed)
        self._shuffle = bool(shuffle)
        self._round_batch = bool(round_batch)
        self._threads = int(preprocess_threads)
        self._device_augment = bool(device_augment)
        self._zero_copy = bool(zero_copy_batches)
        self._augmenter = None

        status = _native.status()
        self.reader, self.decoder = status["reader"], status["decoder"]
        native_read = self.reader == "native"
        scanned = _native.build_index(path_imgrec) if native_read else None
        if path_imgidx and os.path.isfile(path_imgidx):
            idx = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            offsets = [idx.idx[k] for k in idx.keys]
            idx.close()
        elif scanned is not None:
            offsets = scanned[0].tolist()
        else:
            offsets = _scan_offsets(path_imgrec)
        lengths = None
        if scanned is not None:
            # the native reader reads by (offset, length); an index file's
            # offsets are record starts, so the scan gives their lengths
            length_of = dict(zip(scanned[0].tolist(), scanned[1].tolist()))
            if all(o in length_of for o in offsets):
                lengths = [length_of[o] for o in offsets]
        if lengths is None and native_read:
            self.reader = "python (index offsets are not record starts)"
        if num_parts > 1:
            per = (len(offsets) + num_parts - 1) // num_parts
            part = slice(part_index * per, (part_index + 1) * per)
            offsets = offsets[part]
            lengths = lengths[part] if lengths is not None else None
        self.num_data = len(offsets)
        assert self.num_data > 0, "empty record file"
        self._order = np.arange(self.num_data)

        # one decode recipe for the thread path AND the worker processes —
        # shared code is what makes preprocess_processes>0 bitwise-identical
        self._spec = _pl.DecodeSpec(
            path_imgrec, self._data_shape, offsets, lengths,
            resize=self._resize, rand_crop=self._rand_crop,
            mean=self._mean, std=self._std, scale=self._scale,
            dtype=self._dtype, batch_size=self.batch_size,
            device_augment=self._device_augment,
            label_width=self._label_width,
            native_read=lengths is not None,
            native_decode=self.decoder == "native")
        if self._device_augment and self._rand_crop:
            ch, cw = self._spec.canvas_hw
            _c, h, w = self._data_shape
            if (ch, cw) == (h, w):
                raise ValueError(
                    "device_augment with rand_crop needs a crop margin: "
                    f"the decode canvas {ch}x{cw} equals the crop target, "
                    "so the device prologue would silently skip cropping — "
                    "set resize larger than the data_shape spatial dims")

        self._procs = int(preprocess_processes)
        self._held_slot = None
        self._meta = {}
        self._epoch_rng_state = None    # rng snapshot at epoch start (mp)
        self._mp_consumed = 0           # completed next() calls this epoch
        if self._procs > 0:
            self._pipeline = _pl.ProcessDecodePool(
                self._spec, self._procs, ring_slots=ring_slots,
                respawn=worker_respawn, timeout=pipeline_timeout)
            self._pool = None
        else:
            self._pipeline = None
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self._threads)
        self.reset()

    @property
    def provide_data(self):
        if self._device_augment:
            # uint8 canvas out; crop/flip/normalize/widen happen on device
            return [DataDesc("data", self._spec.slot_shape,
                             np.dtype(np.uint8))]
        return [DataDesc("data", (self.batch_size,) + self._data_shape,
                         np.dtype(self._dtype))]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc("softmax_label", shp, np.float32)]

    @property
    def augmenter(self):
        """The device prologue matching this iterator's configuration
        (``device_augment=True`` only): call it on the staged uint8 batch
        with the batch's ``augment_flip``/``augment_crop`` arrays."""
        if not self._device_augment:
            return None
        if self._augmenter is None:
            from ..image import DeviceAugmenter
            c, h, w = self._data_shape
            self._augmenter = DeviceAugmenter(
                (h, w), mean=self._mean, std=self._std, scale=self._scale,
                rand_crop=self._rand_crop, rand_mirror=self._rand_mirror)
        return self._augmenter

    def _epoch_batches(self):
        """Batches one epoch yields — the exact ``iter_next`` count."""
        n, b = self.num_data, self.batch_size
        return (n + b - 1) // b if self._round_batch else n // b

    def _sel_for(self, seq):
        """Record selection of epoch batch ``seq`` — the same arithmetic
        ``next()`` uses on the thread path."""
        start = seq * self.batch_size
        end = start + self.batch_size
        if end <= self.num_data:
            return self._order[start:end]
        pad = end - self.num_data
        return np.concatenate([self._order[start:], self._order[:pad]])

    def _draw(self, n):
        """One batch's flips and crop fractions, in the JAX package's
        order of draws."""
        flips = self._rng.rand(n) < 0.5 if self._rand_mirror \
            else np.zeros(n, dtype=bool)
        return flips, self._rng.rand(n, 2)

    def _task_gen(self):
        """Per-batch decode tasks in seq order.  Flip/crop randomness is
        drawn HERE, in dispatch (== seq) order, so the RNG stream is draw-
        for-draw identical to the thread path's lazy per-``next()`` draws."""
        for seq in range(self._epoch_batches()):
            sel = self._sel_for(seq)
            flips, crops = self._draw(len(sel))
            self._meta[seq] = (sel, flips, crops)
            yield sel, flips, crops

    def reset(self):
        if self._pipeline is not None:
            # abort BEFORE touching the rng: releasing the held slot pumps
            # the dispatcher, and the old epoch's generator must not draw
            # post-rewind randomness
            self._pipeline.abort_epoch()
            if self._held_slot is not None:
                self._pipeline.release(self._held_slot)
                self._held_slot = None
            if self._epoch_rng_state is not None:
                # the pool draws at dispatch time, ahead of consumption;
                # rewind to the epoch's start and replay only the consumed
                # batches' draws, where the thread path's stream would be
                self._rng.set_state(self._epoch_rng_state)
                for _ in range(self._mp_consumed):
                    self._draw(self.batch_size)
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = -self.batch_size
        if self._pipeline is not None:
            self._meta = {}
            self._epoch_rng_state = self._rng.get_state()
            self._mp_consumed = 0
            if self._pipeline.workers_alive:
                self._pipeline.clear_error()
            self._pipeline.start_epoch(self._task_gen(),
                                       self._epoch_batches())

    def iter_next(self):
        self._cursor += self.batch_size
        if self._round_batch:
            return self._cursor < self.num_data
        return self._cursor + self.batch_size <= self.num_data

    def _next_multiprocess(self):
        """The ``preprocess_processes>0`` path: the next in-order slot of
        the decode pool, copied once into pinned memory (or, under
        ``zero_copy_batches=True``, the slot itself).  The previous batch's
        slot is recycled here."""
        from .pipeline import BatchDecodeError
        # a failed pool keeps raising, at the end of an epoch too: it never
        # reads as the epoch's end
        self._pipeline.raise_if_failed()
        if not self.iter_next():
            raise StopIteration
        if self._held_slot is not None:
            self._pipeline.release(self._held_slot)
            self._held_slot = None
        try:
            seq, view, labels, slot = self._pipeline.next_batch()
        except BatchDecodeError as e:
            # per-batch error, thread-path contract: the batch is accounted
            # (its draws happened; the cursor advanced)
            self._mp_consumed += 1
            self._meta.pop(e.seq, None)
            raise
        self._held_slot = slot
        self._mp_consumed += 1
        sel, flips, crops = self._meta.pop(seq)
        pad = self.getpad()
        if _tel.enabled:
            _tel.count("io.record_batches")
            _tel.count("io.staging_bytes", view.nbytes + labels.nbytes)
        data = torch.from_numpy(view) if self._zero_copy else None
        batch = DataBatch(
            data=[NDArray(data) if data is not None else host_array(view)],
            label=[host_array(labels)], pad=pad, index=sel.copy())
        if self._device_augment:
            batch.augment_flip = flips
            batch.augment_crop = crops
        return batch

    def close(self):
        """Tear down decode resources (worker processes, shm ring, thread
        pool).  Idempotent; also runs from ``__del__`` and atexit."""
        pl = getattr(self, "_pipeline", None)
        if pl is not None:
            pl.close()
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def next(self):
        if self._pipeline is not None:
            return self._next_multiprocess()
        if not self.iter_next():
            raise StopIteration
        start, end = self._cursor, self._cursor + self.batch_size
        if end <= self.num_data:
            sel = self._order[start:end]
            pad = 0
        else:
            pad = end - self.num_data
            sel = np.concatenate([self._order[start:], self._order[:pad]])
        with _tel.span("io.read_records", n=len(sel)):
            raws = self._spec.read_many(sel)
        flips, crops = self._draw(len(sel))
        if self._device_augment:
            # in-process canvas decode (decode only; augmentation is the
            # device prologue) — the procs=0 twin of the worker path
            out = pinned_empty(self._spec.slot_shape, torch.uint8)
            with _tel.span("io.decode_batch", decoder="canvas", n=len(sel)):
                labels = self._spec.decode_canvas(raws, self._threads,
                                                  out.numpy())
            if _tel.enabled:
                _tel.count("io.record_batches")
            batch = DataBatch(data=[NDArray(out)], label=[host_array(labels)],
                              pad=pad, index=sel.copy())
            batch.augment_flip = flips
            batch.augment_crop = crops
            return batch
        # io.decode_wait_ms: how long the caller of next() (the training
        # loop, or a PrefetchingIter producer) waits on the decode itself
        t0 = time.perf_counter()
        native = None
        data = None
        if self._spec.native_decode:
            if np.dtype(self._dtype) == np.float32:
                data = pinned_empty((len(sel),) + self._data_shape)
            native = self._spec.decode_batch_native(
                raws, flips, crops, self._threads,
                out=data.numpy() if data is not None else None)
        if native is not None:
            if _tel.enabled:
                _tel.count("io.decode_wait_ms",
                           (time.perf_counter() - t0) * 1e3,
                           decoder="native")
                _tel.record_span("io.decode_batch", t0, decoder="native",
                                 n=len(sel))
            arr, labels = native
            batch_data = NDArray(data) if data is not None else host_array(
                arr.astype(self._dtype, copy=False))
        else:
            # restamp: a failed native attempt (non-JPEG sniff) is not
            # pool wait
            t0 = time.perf_counter()
            try:
                with _tel.span("io.decode_batch", decoder="pool",
                               n=len(sel), threads=self._threads):
                    decoded = list(self._pool.map(self._spec.decode_one,
                                                  raws, flips, crops))
            except Exception:
                if _tel.enabled:
                    _tel.count("io.worker_error", stage="decode")
                raise
            if _tel.enabled:
                _tel.count("io.decode_wait_ms",
                           (time.perf_counter() - t0) * 1e3, decoder="pool")
            batch_data = host_array(
                np.stack([d for d, _ in decoded]).astype(self._dtype))
            labels = np.stack([l for _, l in decoded])
        if _tel.enabled:
            _tel.count("io.record_batches")
        return DataBatch(data=[batch_data], label=[host_array(labels)],
                         pad=pad, index=sel.copy())

    def getpad(self):
        return max(0, self._cursor + self.batch_size - self.num_data)


def _scan_offsets(path):
    """Record offsets of a .rec file by Python's framing walk."""
    from .. import recordio
    rec = recordio.MXRecordIO(path, "r")
    offsets = []
    try:
        while True:
            pos = rec.record.tell()
            if rec.read() is None:
                break
            offsets.append(pos)
    finally:
        rec.close()
    return offsets


def ImageDetRecordIter(path_imgrec=None, data_shape=None, batch_size=1,
                       path_imgidx=None, shuffle=False, label_pad_width=None,
                       label_pad_value=-1.0, max_objects=None, **kwargs):
    """Detection record iterator (reference ``ImageDetRecordIter``,
    src/io/iter_image_det_recordio.cc): ``.rec`` packs whose headers carry
    ``[header_width, obj_width, cls, x1, y1, x2, y2, ...]`` labels.

    A front for :class:`mxnet_tpu_torch.image.ImageDetIter` with the
    record iterators' argument convention: ``label_pad_width`` (the whole
    padded label, 2 + max_objects * 5 in the reference) sets
    ``max_objects``; ``mean_r/g/b`` and ``std_r/g/b`` normalise per
    channel; any other argument the iterator does not know raises.
    """
    from ..image import ImageDetIter
    if max_objects is None:
        max_objects = max((int(label_pad_width) - 2) // 5, 1) \
            if label_pad_width else 8
    shape = _maybe_parse_shape(data_shape)
    aug_kwargs = {k: v for k, v in kwargs.items()
                  if k in ("resize", "rand_crop", "rand_mirror",
                           "mean", "std")}
    mean_rgb = [kwargs.pop(k, 0.0) for k in ("mean_r", "mean_g", "mean_b")]
    std_rgb = [kwargs.pop(k, 1.0) for k in ("std_r", "std_g", "std_b")]
    if any(v != 0.0 for v in mean_rgb):
        aug_kwargs["mean"] = np.asarray(mean_rgb, np.float32)
    if any(v != 1.0 for v in std_rgb):
        aug_kwargs["std"] = np.asarray(std_rgb, np.float32)
    known = {"round_batch", "preprocess_threads", "seed", "verbose",
             "part_index", "num_parts"}
    unknown = set(kwargs) - known - set(aug_kwargs)
    if unknown:
        raise TypeError(f"ImageDetRecordIter: unsupported arguments "
                        f"{sorted(unknown)}")
    return ImageDetIter(batch_size=int(batch_size), data_shape=shape,
                        path_imgrec=path_imgrec, path_imgidx=path_imgidx,
                        shuffle=shuffle, max_objects=max_objects,
                        label_pad_value=float(label_pad_value),
                        **aug_kwargs)
