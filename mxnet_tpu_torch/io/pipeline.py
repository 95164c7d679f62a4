"""Multi-process decode pipeline behind ``ImageRecordIter`` (the port's
copy of ``mxnet_tpu/io/pipeline.py``).

MXNet decodes JPEGs on an OMP thread pool inside one process
(``src/io/iter_image_recordio_2.cc``); this module moves decode across
*processes*:

- :class:`DecodeSpec` is the pickleable decode recipe shared by the in-process
  thread path and the worker processes — one code path, so
  ``preprocess_processes=N`` is bitwise-identical to the thread path.  The
  parent picks the decoder once (native libjpeg or cv2, ``_native``) and
  the workers inherit the choice.
- :func:`_worker_main` is the fork-started worker loop: read its task's
  records (own file handle), decode, and assemble the batch *directly into a
  shared-memory ring slot* (``io/shm_ring.py``) — no pickling, no per-image
  copies.
- :class:`ProcessDecodePool` is the parent-side orchestrator: static
  round-robin task assignment (seq → seq % N), in-order reassembly, bounded
  waits with worker-death detection (a sticky error by default,
  respawn with backoff when ``respawn=True``) and ``io.*`` telemetry.
- :class:`RecordShardSampler` keys record sharding off explicit
  ``(num_parts, part_index)``.

Workers are forked, as in the JAX package: the slots are inherited mappings
and a worker starts in milliseconds.  The parent may have initialised CUDA;
a forked child is safe as long as it makes no CUDA call, so a worker runs
numpy, ctypes (the native reader and decoder) and cv2 only, and never a
torch function.  It leaves cv2's thread pool as it inherited it (OpenCV
rebuilds its pool in a forked child; resizing the pool there deadlocks).
Whatever a worker does, the parent waits on it with a bound
(``pipeline_timeout``, default 60 s or ``MXNET_IO_PIPELINE_TIMEOUT``): a
dead or hung worker ends in an error, never a hang.
"""
from __future__ import annotations

import os
import struct
import time
import traceback

import numpy as np

from ..telemetry import bus as _tel
from .shm_ring import ShmRing

__all__ = ["BatchDecodeError", "DecodeSpec", "ProcessDecodePool",
           "RecordShardSampler"]


class BatchDecodeError(RuntimeError):
    """A worker failed to decode ONE batch (truncated JPEG, bad record).

    Matches the thread path's per-batch contract: the error surfaces once
    for the offending batch — with the worker's traceback — and the
    pipeline keeps serving subsequent batches.  Worker *death* is a
    different, sticky error."""

    def __init__(self, seq, wid, worker_traceback):
        super().__init__(
            f"io pipeline worker {wid} failed decoding batch {seq}:\n"
            f"{worker_traceback}")
        self.seq = seq

_MAGIC = 0xced7230a
_CFLAG_BITS = 29
_LEN_MASK = (1 << _CFLAG_BITS) - 1

_JPEG_SOI = b"\xff\xd8\xff"


class RecordShardSampler:
    """Which contiguous shard of a record file this reader owns.

    ``shard(n)`` mirrors the reference ``kParts`` handling
    (``iter_image_recordio_2.cc``): record ``i`` belongs to this reader iff
    ``i`` falls in the contiguous ``part_index``-th slice of ``n`` records.
    """

    def __init__(self, num_parts=1, part_index=0):
        num_parts, part_index = int(num_parts), int(part_index)
        if num_parts < 1 or not 0 <= part_index < num_parts:
            raise ValueError(
                f"bad shard ({part_index} of {num_parts})")
        self.num_parts = num_parts
        self.part_index = part_index

    @classmethod
    def from_mesh(cls, mesh=None, axis="dp"):
        """Shard by a device mesh's data axis: the port has no mesh yet."""
        raise NotImplementedError(
            "RecordShardSampler.from_mesh: the port has no device mesh yet "
            "(ROADMAP.md queue 1, item 9); pass num_parts/part_index")

    def shard(self, n):
        """``slice`` of ``range(n)`` this reader owns."""
        per = (n + self.num_parts - 1) // self.num_parts
        return slice(self.part_index * per,
                     min(n, (self.part_index + 1) * per))

    def __repr__(self):
        return (f"RecordShardSampler({self.part_index}/{self.num_parts})")


class DecodeSpec:
    """Pickleable decode recipe + record access for one ``.rec`` source.

    Both the iterator's in-process thread pool and the fork-started worker
    processes decode through this object, so the two paths cannot drift.
    ``device_augment=False``: full host augmentation (resize → crop → mirror
    → normalize), output ``dtype`` CHW.  ``device_augment=True``: decode to
    a fixed uint8 canvas only — crop/flip/normalize/f32-widen run as the
    device prologue (``mxnet_tpu_torch.image.DeviceAugmenter``).
    ``native_read``/``native_decode``: the parent's choice of reader and
    decoder (``_native``), which the workers inherit.
    """

    def __init__(self, path, data_shape, offsets, lengths, resize=-1,
                 rand_crop=False, mean=(0., 0., 0.), std=(1., 1., 1.),
                 scale=1.0, dtype="float32", batch_size=1,
                 device_augment=False, label_width=1, native_read=False,
                 native_decode=False):
        self.path = path
        self.data_shape = tuple(data_shape)
        self.offsets = offsets          # one per owned record, read order
        self.lengths = lengths          # parallel to offsets, or None
        self.label_width = int(label_width)
        self.resize = int(resize)
        self.rand_crop = bool(rand_crop)
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.scale = float(scale)
        self.dtype = np.dtype(dtype)
        self.batch_size = int(batch_size)
        self.device_augment = bool(device_augment)
        self.native_read = bool(native_read)
        self.native_decode = bool(native_decode)
        self._fh = None                 # per-process file handle

    # ------------------------------------------------------------ slot layout
    @property
    def canvas_hw(self):
        """Fixed decode canvas in device-augment mode: ``(resize, resize)``
        when a resize is configured, else the crop target itself."""
        c, h, w = self.data_shape
        if self.resize > 0:
            return (max(self.resize, h), max(self.resize, w))
        return (h, w)

    @property
    def slot_shape(self):
        if self.device_augment:
            ch, cw = self.canvas_hw
            return (self.batch_size, 3, ch, cw)
        return (self.batch_size,) + self.data_shape

    @property
    def slot_dtype(self):
        return np.dtype(np.uint8) if self.device_augment else self.dtype

    @property
    def label_shape(self):
        return (self.batch_size, self.label_width)

    def data_nbytes(self):
        n = 1
        for d in self.slot_shape:
            n *= int(d)
        return n * self.slot_dtype.itemsize

    def slot_nbytes(self):
        # pixels + the label block: labels ride in shared memory too, so
        # result messages stay tiny (single atomic pipe write) and nothing
        # crosses processes pickled
        return self.data_nbytes() + self.batch_size * self.label_width * 4

    # ---------------------------------------------------------- record access
    def reopen(self):
        """(Re)open a private file handle — mandatory after fork: a handle
        inherited from the parent shares its file *description*, so worker
        seeks would race the parent's reads."""
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:
                pass
        self._fh = open(self.path, "rb")

    def _read_framed(self, offset):
        """One logical record at ``offset`` via RecordIO framing (the
        Python mirror of ``recordio.MXRecordIO.read`` over a raw handle)."""
        fh = self._fh
        fh.seek(offset)
        parts = []
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                raise IOError(f"truncated record at {offset} in {self.path}")
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _MAGIC:
                raise IOError(f"invalid record magic {magic:#x} in {self.path}")
            cflag, length = lrec >> _CFLAG_BITS, lrec & _LEN_MASK
            data = fh.read(length)
            if len(data) < length:
                raise IOError(f"truncated record in {self.path}")
            pad = (4 - length % 4) % 4
            if pad:
                fh.read(pad)
            if cflag == 0:
                return data
            parts.append(data)
            if cflag == 3:
                return b"".join(parts)

    def read_many(self, sel):
        """Raw record payloads for a batch of record indices — one native
        batched read when offset+length pairs are known, framed Python IO
        otherwise."""
        if self.lengths is not None and self.native_read:
            from .. import _native
            return _native.read_batch(self.path,
                                      [self.offsets[i] for i in sel],
                                      [self.lengths[i] for i in sel])
        if self._fh is None:
            self.reopen()
        return [self._read_framed(self.offsets[i]) for i in sel]

    # ----------------------------------------------------------------- decode
    def decode_one(self, raw, mirror_flip, crop_xy):
        """Host-augment decode of ONE record: cv2 path (BGR decode → resize
        → crop → mirror → RGB normalize → CHW).  The exact math of the
        pre-pipeline ``ImageRecordIter._decode_one``."""
        import cv2
        from .. import recordio
        header, img = recordio.unpack_img(raw, iscolor=1)
        c, h, w = self.data_shape
        if self.resize > 0:
            ih, iw = img.shape[:2]
            if ih < iw:
                nh, nw = self.resize, int(iw * self.resize / ih)
            else:
                nh, nw = int(ih * self.resize / iw), self.resize
            img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = cv2.resize(img, (max(w, iw), max(h, ih)),
                             interpolation=cv2.INTER_LINEAR)
            ih, iw = img.shape[:2]
        if self.rand_crop:
            y0 = int(crop_xy[0] * (ih - h + 1))
            x0 = int(crop_xy[1] * (iw - w + 1))
        else:
            y0, x0 = (ih - h) // 2, (iw - w) // 2
        img = img[y0:y0 + h, x0:x0 + w]
        if mirror_flip:
            img = img[:, ::-1]
        img = img[:, :, ::-1].astype(np.float32)  # BGR → RGB
        img = (img - self.mean) / self.std * self.scale
        label = self._label_of(header)
        return np.transpose(img, (2, 0, 1)), label

    @staticmethod
    def _label_of(header):
        label = header.label
        if not np.isscalar(label) and getattr(label, "size", 1) > 1:
            return np.asarray(label, dtype=np.float32)
        return np.float32(label)

    def decode_batch_native(self, raws, flips, crops, n_threads, out=None):
        """Whole-batch host-augment decode in one native call (the
        reference's in-iterator OMP pipeline).  Returns ``(data, labels)``
        or None when the payloads are not all-JPEG / libjpeg balks (the
        caller falls back to cv2)."""
        from .. import _native, recordio
        headers, payloads = [], []
        for raw in raws:
            header, payload = recordio.unpack(raw)
            if not payload[:3] == _JPEG_SOI:
                return None
            headers.append(header)
            payloads.append(payload)
        c, h, w = self.data_shape
        try:
            data = _native.decode_batch(
                payloads, (h, w), resize=self.resize,
                crop_xy=crops if self.rand_crop else None,
                mirror=np.asarray(flips).astype(np.uint8),
                mean=self.mean, std=self.std, scale=self.scale,
                n_threads=n_threads,
                out=out if out is not None
                and out.dtype == np.float32 else None)
        except IOError:
            # e.g. CMYK/YCCK JPEGs libjpeg won't convert — cv2 handles them
            return None
        labels = [self._label_of(header) for header in headers]
        return data, np.stack(labels)

    def decode_canvas(self, raws, n_threads, out):
        """Device-augment mode: decode+resize each JPEG to the fixed uint8
        CHW canvas, straight into ``out`` — native canvas decoder when
        available, cv2 otherwise.  Returns the label stack."""
        from .. import _native, recordio
        ch, cw = self.canvas_hw
        headers, payloads = [], []
        for raw in raws:
            header, payload = recordio.unpack(raw)
            headers.append(header)
            payloads.append(payload)
        native_ok = (self.native_decode
                     and all(p[:3] == _JPEG_SOI for p in payloads))
        if native_ok:
            try:
                _native.decode_batch_u8(payloads, (ch, cw),
                                        n_threads=n_threads, out=out)
            except IOError:
                native_ok = False
        if not native_ok:
            import cv2
            for i, payload in enumerate(payloads):
                img = cv2.imdecode(np.frombuffer(payload, dtype=np.uint8),
                                   cv2.IMREAD_COLOR)
                if img is None:
                    raise IOError(f"cv2 could not decode record {i}")
                if img.shape[:2] != (ch, cw):
                    img = cv2.resize(img, (cw, ch),
                                     interpolation=cv2.INTER_LINEAR)
                out[i] = np.transpose(img[:, :, ::-1], (2, 0, 1))
        return np.stack([self._label_of(h) for h in headers])

    def decode_into(self, sel, flips, crops, out, n_threads=1):
        """Worker entry: read + decode one batch straight into the slot
        view ``out``.  Returns the batch's label stack."""
        raws = self.read_many(sel)
        if self.device_augment:
            return self.decode_canvas(raws, n_threads, out)
        native = self.decode_batch_native(raws, flips, crops, n_threads,
                                          out=out) \
            if self.native_decode else None
        if native is not None:
            data, labels = native
            if data is not out:          # non-f32 slot: one batch-level cast
                np.copyto(out, data.astype(self.dtype, copy=False))
            return labels
        decoded = [self.decode_one(raw, f, c)
                   for raw, f, c in zip(raws, flips, crops)]
        for i, (img, _) in enumerate(decoded):
            np.copyto(out[i], img.astype(self.dtype, copy=False))
        return np.stack([l for _, l in decoded])


def _worker_main(wid, spec, ring, task_q, conn, n_threads):
    """Decode-worker loop (fork-started, daemon).  Protocol:

    task:   ``("batch", epoch, seq, slot, sel, flips, crops)`` or ``("stop",)``
    result: ``("ok", epoch, seq, slot, decode_ms)`` or
            ``("err", epoch, seq, slot, traceback_str)`` on the worker's OWN
            one-way pipe ``conn`` — one writer per pipe and sub-PIPE_BUF
            messages (labels ride in the shm slot, never pickled), so a
            SIGKILLed worker can neither poison a shared lock nor leave a
            torn message for the survivors.

    Fault injection (``io.shm_slot``) is ROADMAP.md item 10; the tests kill
    a worker with a signal instead.
    """
    spec._fh = None
    try:
        spec.reopen()
    except Exception:
        os._exit(13)
    while True:
        msg = task_q.get()
        if msg[0] == "stop":
            return
        _, epoch, seq, slot, sel, flips, crops = msg
        t0 = time.perf_counter()
        try:
            out = ring.view(slot, spec.slot_shape, spec.slot_dtype)
            labels = spec.decode_into(sel, flips, crops, out,
                                      n_threads=n_threads)
            lab_view = ring.view(slot, spec.label_shape, np.float32,
                                 offset=spec.data_nbytes())
            lab_view[:] = np.asarray(labels, np.float32).reshape(
                spec.label_shape)
            conn.send(("ok", epoch, seq, slot,
                       (time.perf_counter() - t0) * 1e3))
        except BaseException:
            conn.send(("err", epoch, seq, slot,
                       traceback.format_exc(limit=16)[-2048:]))


class ProcessDecodePool:
    """Parent-side orchestrator of N fork-started decode workers.

    Tasks are assigned statically (seq → ``seq % N``) so the parent always
    knows which worker owns an unfinished batch: worker death recovers
    without a claim protocol — queued tasks survive in the dead worker's
    queue, and only the single task it had *started* needs requeueing.
    Results reassemble in seq order, so epoch batch order (and therefore
    the shuffle/flip/crop RNG stream) is identical to the thread path.
    """

    def __init__(self, spec, num_procs, ring_slots=None, respawn=False,
                 timeout=None, decode_threads=1, tag="mxt_io"):
        import multiprocessing as mp
        if "fork" not in mp.get_all_start_methods():
            raise RuntimeError(
                "preprocess_processes>0 needs the fork start method "
                "(shared-memory ring slots are inherited, not re-attached)")
        self._ctx = mp.get_context("fork")
        self._spec = spec
        self._n = int(num_procs)
        self._decode_threads = max(1, int(decode_threads))
        self._respawn = bool(respawn)
        self._timeout = float(timeout if timeout is not None else
                              os.environ.get("MXNET_IO_PIPELINE_TIMEOUT", 60))
        n_slots = int(ring_slots) if ring_slots else max(2 * self._n,
                                                         self._n + 2)
        self.ring = ShmRing(n_slots, spec.slot_nbytes(), tag=tag)
        self._task_qs = [None] * self._n
        self._conns = [None] * self._n     # parent end of each result pipe
        self._procs = [None] * self._n

        self._epoch = 0
        self._gen = None
        self._n_batches = 0
        self._dispatched = 0
        self._consumed = 0
        self._done = {}          # seq -> (slot, decode_ms)
        self._pending = {}       # seq -> task msg (dispatched, unresulted)
        self._stale = {}         # (epoch, seq) -> (slot, wid): in-flight
        #                          tasks orphaned by a reset() mid-epoch
        self._sticky = None
        self._closed = False
        for wid in range(self._n):
            self._spawn(wid)

    # ----------------------------------------------------------------- spawn
    def _spawn(self, wid):
        """Start (or replace) worker ``wid`` with a FRESH task queue and
        result pipe.  Fresh on purpose: a worker SIGKILLed inside
        ``Queue.get`` dies holding the queue's reader semaphore, which no
        one ever releases — a respawn reading the old queue would deadlock.
        The replaced queue/pipe are simply abandoned (their in-flight tasks
        are re-dispatched by ``_check_workers``)."""
        old_q = self._task_qs[wid]
        if old_q is not None:
            try:
                old_q.cancel_join_thread()
                old_q.close()
            except Exception:
                pass
        old_c = self._conns[wid]
        if old_c is not None:
            try:
                old_c.close()
            except Exception:
                pass
        self._task_qs[wid] = self._ctx.Queue()
        recv_c, send_c = self._ctx.Pipe(duplex=False)
        self._conns[wid] = recv_c
        p = self._ctx.Process(
            target=_worker_main,
            args=(wid, self._spec, self.ring, self._task_qs[wid], send_c,
                  self._decode_threads),
            daemon=True, name=f"mxio-decode-{wid}")
        import warnings
        with warnings.catch_warnings():
            # Python warns on any fork of a multithreaded parent; these
            # workers make no torch or CUDA call — they decode with
            # numpy/ctypes/cv2 only (see the module docstring)
            warnings.filterwarnings("ignore", message=".*fork.*",
                                    category=DeprecationWarning)
            warnings.filterwarnings("ignore", message=".*os.fork.*",
                                    category=RuntimeWarning)
            p.start()
        send_c.close()           # parent keeps only the read end
        self._procs[wid] = p
        return p

    # ------------------------------------------------------------- epoch API
    def abort_epoch(self):
        """Stop dispatching from the current epoch's generator.  Callers
        rewinding the RNG the generator draws from (``reset()``) must abort
        FIRST — a slot release in between would otherwise pump stale-epoch
        tasks and consume post-rewind randomness."""
        self._gen = None
        self._n_batches = self._dispatched

    def start_epoch(self, task_gen, n_batches):
        """Begin an epoch: ``task_gen`` yields ``(sel, flips, crops)`` in
        seq order (the parent draws augmentation randomness, so the RNG
        stream matches the single-process path draw for draw)."""
        self._epoch += 1
        self._gen = task_gen
        self._n_batches = int(n_batches)
        self._dispatched = 0
        self._consumed = 0
        # reclaim slots parked in stale results; in-flight tasks keep their
        # slots until their (stale) result lands — or until their worker
        # dies, when _check_workers reclaims them (the only other writer)
        for entry in self._done.values():
            if not isinstance(entry, BatchDecodeError):
                self.ring.release(entry[0])
        self._done.clear()
        for seq, msg in self._pending.items():
            self._stale[(msg[1], seq)] = (msg[3], seq % self._n)
        self._pending.clear()
        self._pump()

    def _pump(self):
        """Dispatch tasks while slots are free (windowed backpressure: at
        most ``ring.n_slots`` batches in flight)."""
        if self._gen is None:
            return
        while self._dispatched < self._n_batches:
            slot = self.ring.acquire()
            if slot is None:
                return
            try:
                sel, flips, crops = next(self._gen)
            except StopIteration:
                self.ring.release(slot)
                self._n_batches = self._dispatched
                return
            seq = self._dispatched
            msg = ("batch", self._epoch, seq, slot,
                   np.asarray(sel), flips, crops)
            self._pending[seq] = msg
            self._task_qs[seq % self._n].put(msg)
            self._dispatched += 1

    # ----------------------------------------------------------- result side
    def _handle(self, wid, msg):
        kind, epoch, seq, slot = msg[0], msg[1], msg[2], msg[3]
        if epoch != self._epoch or seq < self._consumed or seq in self._done:
            # stale epoch (reset() raced an in-flight batch): reclaim its
            # slot.  Duplicates cannot happen — a dead worker's pipe is
            # abandoned unread, so each live seq has exactly one result.
            if epoch != self._epoch and \
                    self._stale.pop((epoch, seq), None) is not None:
                self.ring.release(slot)
            return
        self._pending.pop(seq, None)
        if kind == "ok":
            self._done[seq] = (slot, msg[4])
        else:
            self.ring.release(slot)
            if _tel.enabled:
                _tel.count("io.worker_error", stage="process")
                _tel.instant("io.worker_error", stage="process", worker=wid,
                             seq=seq)
            # per-batch, NOT sticky: parked under the seq and raised once
            # when the consumer reaches it (thread-path parity — the worker
            # survives and later batches keep flowing)
            self._done[seq] = BatchDecodeError(seq, wid, msg[4])

    def _poll_results(self, timeout=0.0):
        """Read every complete result currently available (bounded wait for
        the first one)."""
        from multiprocessing import connection as _mpc
        conns = [c for c in self._conns if c is not None and not c.closed]
        try:
            ready = _mpc.wait(conns, timeout)
        except OSError:
            ready = []
        for conn in ready:
            wid = self._conns.index(conn)
            while True:
                try:
                    if not conn.poll(0):
                        break
                    self._handle(wid, conn.recv())
                except (EOFError, OSError):
                    break        # writer died; liveness check handles it

    def _check_workers(self):
        for wid, p in enumerate(self._procs):
            if p is not None and p.is_alive():
                continue
            exitcode = p.exitcode if p is not None else None
            owned = sorted(s for s in self._pending if s % self._n == wid)
            if not self._respawn:
                self._sticky = RuntimeError(
                    f"io pipeline worker {wid} died (exit {exitcode}) with "
                    f"{len(owned)} batches outstanding")
                return
            if _tel.enabled:
                _tel.count("io.worker_respawns")
                _tel.instant("io.worker_respawn", worker=wid,
                             exitcode=exitcode)
            # drain the dead worker's pipe for already-completed batches,
            # then abandon it: _spawn swaps in a fresh queue+pipe (the old
            # queue's reader semaphore may have died locked) and every
            # still-pending batch it owned is re-dispatched from scratch
            self._poll_results(0.0)
            self._respawn_with_backoff(wid)
            for seq in sorted(s for s in self._pending
                              if s % self._n == wid):
                self._task_qs[wid].put(self._pending[seq])
            # stale tasks the dead worker owned died with its queue — no
            # writer is left, so their slots return to the ring here
            for key in [k for k, (_s, w) in self._stale.items()
                        if w == wid]:
                self.ring.release(self._stale.pop(key)[0])

    def next_batch(self):
        """Blocking, in-order: ``(seq, data_view, labels, slot_id)`` for the
        next seq.  The view aliases the shm slot — the caller owns it until
        it calls :meth:`release` with the slot id."""
        if self._sticky is not None:
            raise self._sticky
        if self._consumed >= self._n_batches:
            raise StopIteration
        self._pump()
        seq = self._consumed
        t0 = time.perf_counter()
        deadline = t0 + self._timeout
        while seq not in self._done:
            self._poll_results(0.25)
            if self._sticky is not None:
                raise self._sticky
            # a stale-epoch or errored result may have just freed slots the
            # fresh epoch is waiting on — top the dispatch window back up
            self._pump()
            if seq in self._done:
                break
            self._check_workers()
            if self._sticky is not None:
                raise self._sticky
            if time.perf_counter() > deadline:
                self._sticky = RuntimeError(
                    f"io pipeline stalled: batch {seq} not produced within "
                    f"{self._timeout:.0f}s ({len(self._pending)} pending)")
                raise self._sticky
        entry = self._done.pop(seq)
        if isinstance(entry, BatchDecodeError):
            # one bad batch, one raise; the NEXT call serves seq+1 (the
            # thread path's per-batch error contract)
            self._consumed += 1
            self._pump()
            raise entry
        slot, decode_ms = entry
        self._consumed += 1
        if _tel.enabled:
            now = time.perf_counter()
            _tel.count("io.proc_decode_wait_ms", (now - t0) * 1e3)
            _tel.count("io.proc_decode_ms", decode_ms)
            _tel.record_span("io.proc_batch_wait", t0, now, seq=seq,
                             decode_ms=round(decode_ms, 3))
        self.ring.gauge_occupancy()
        view = self.ring.view(slot, self._spec.slot_shape,
                              self._spec.slot_dtype)
        labels = self.ring.view(slot, self._spec.label_shape, np.float32,
                                offset=self._spec.data_nbytes()).copy()
        if self._spec.label_width == 1:
            labels = labels.reshape(self._spec.batch_size)
        return seq, view, labels, slot

    def raise_if_failed(self):
        """Raise the pool's sticky error (a dead worker without respawn, a
        stall), if it has one."""
        if self._sticky is not None:
            raise self._sticky

    def release(self, slot):
        """Consumer is done with a slot's view — recycle it and top up the
        dispatch window."""
        self.ring.release(slot)
        if self._sticky is None and self._gen is not None:
            self._pump()

    def _respawn_with_backoff(self, wid, attempts=3, base_delay_s=0.1):
        """Respawn worker ``wid``, retrying a failed start with exponential
        backoff; the last failure propagates."""
        for attempt in range(attempts):
            try:
                return self._spawn(wid)
            except Exception:
                if attempt == attempts - 1:
                    raise
                time.sleep(base_delay_s * 2 ** attempt)

    # ---------------------------------------------------------------- fields
    @property
    def workers_alive(self):
        return all(p is not None and p.is_alive() for p in self._procs)

    @property
    def healthy(self):
        return self._sticky is None and self.workers_alive

    def clear_error(self):
        """Drop a sticky error so ``start_epoch`` can try again.  Only
        meaningful while every worker is alive (a stall timeout whose cause
        passed) — ``reset()`` gates on :attr:`workers_alive`; a dead worker
        without respawn stays terminal."""
        self._sticky = None

    # --------------------------------------------------------------- teardown
    def close(self):
        if self._closed:
            return
        self._closed = True
        for q in self._task_qs:
            if q is None:
                continue
            try:
                q.put(("stop",))
            except Exception:
                pass
        for p in self._procs:
            if p is None:
                continue
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        for q in self._task_qs:
            if q is None:
                continue
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass
        for c in self._conns:
            if c is None:
                continue
            try:
                c.close()
            except Exception:
                pass
        self.ring.destroy()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
