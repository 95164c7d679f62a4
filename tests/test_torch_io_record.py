"""The port's record and dataset iterators against the JAX package's, on the
CPU.

- ``ImageRecordIter`` batches, labels and pads equal the JAX package's bit
  for bit over two epochs, with both packages on the native decoder and
  with both forced to cv2 (the JAX package through its
  ``_native.decode_available``, replaced for the test only), over
  ``shuffle``, ``round_batch``, ``resize``, ``rand_crop``, ``rand_mirror``,
  mean/std/scale, ``num_parts`` and an index file.
- The process path (``preprocess_processes=2``) equals the thread path,
  across resets before use and mid-epoch, with host and device
  augmentation; a killed worker ends in a bounded error; the shared-memory
  slots are gone after ``close()``.
- ``PrefetchingIter`` and ``DevicePrefetchIter`` (synchronous staging on
  the CPU) give the iterator's batches; errors reach the consumer.
- ``CSVIter``, ``MNISTIter`` and ``LibSVMIter`` equal the JAX package's.

Three SGD steps of ResNet-18 v1 fed by ``ImageRecordIter`` are in
``test_torch_train.py``, beside the unfed case whose JAX programs they
share.

Every pool here has a ``pipeline_timeout``: no test waits without a bound.
"""
import os
import signal
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import _native as j_native

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _native, recordio

N_IMG, HW = 20, (40, 48)
SHAPE = (3, 32, 32)
TIMEOUT = 20


@pytest.fixture(scope="module")
def rec_files(tmp_path_factory):
    """A .rec of N_IMG seeded JPEGs (labels i % 7) with its .idx."""
    d = tmp_path_factory.mktemp("iorec")
    path, idx = str(d / "img.rec"), str(d / "img.idx")
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, path, "w")
    for i in range(N_IMG):
        img = (rng.rand(*HW, 3) * 255).astype("uint8")
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 7), i, 0), img, quality=85))
    w.close()
    return path, idx


@pytest.fixture(params=["native", "cv2"])
def decoder(request, monkeypatch):
    if request.param == "native":
        assert _native.status()["decoder"] == "native"
        assert j_native.decode_available()
    else:
        monkeypatch.setattr(_native, "status", lambda: {
            "reader": "native", "decoder": "cv2 (forced by the test)"})
        monkeypatch.setattr(j_native, "decode_available", lambda: False)
        monkeypatch.setattr(j_native, "decode_canvas_available",
                            lambda: False)
    return request.param


def _epochs(it, n=2, with_aug=False):
    out = []
    for _ in range(n):
        for b in it:
            row = [b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad]
            if with_aug:
                row += [np.asarray(b.augment_flip),
                        np.asarray(b.augment_crop)]
            out.append(row)
        it.reset()
    return out


def _same(a, b):
    assert len(a) == len(b) and a
    for ra, rb in zip(a, b):
        assert ra[2] == rb[2]
        for x, y in zip(ra[:2] + ra[3:], rb[:2] + rb[3:]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


CASES = {
    "shuffle-crop-mirror-resize-meanstd": dict(
        batch_size=8, shuffle=True, rand_crop=True, rand_mirror=True,
        resize=36, mean_r=123.68, mean_g=116.779, mean_b=103.939,
        std_r=58.393, std_g=57.12, std_b=57.375, seed=3),
    "no-round-batch-centre-scale": dict(
        batch_size=8, round_batch=False, scale=1.0 / 255),
    "parts": dict(batch_size=4, shuffle=True, rand_mirror=True,
                  num_parts=2, part_index=1, seed=5),
    "index-file": dict(batch_size=6, shuffle=True, rand_crop=True,
                       resize=40, seed=9, use_idx=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_matches_jax(rec_files, decoder, case):
    path, idx = rec_files
    kw = dict(CASES[case])
    if kw.pop("use_idx", False):
        kw["path_imgidx"] = idx
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=SHAPE,
                               preprocess_threads=2, **kw)
    assert it.reader == "native"
    assert it.decoder == ("native" if decoder == "native" else
                          "cv2 (forced by the test)")
    jit = jmx.io.ImageRecordIter(path_imgrec=path, data_shape=SHAPE,
                                 preprocess_threads=2, **kw)
    got, want = _epochs(it), _epochs(jit)
    _same(got, want)
    b = mx.io.ImageRecordIter(path_imgrec=path, data_shape=SHAPE, **kw)
    batch = b.next()
    assert batch.data[0].context == mx.cpu()
    assert b.provide_data[0].shape == (kw["batch_size"],) + SHAPE
    it.close()
    b.close()


@pytest.mark.parametrize("device_augment", [False, True])
@pytest.mark.parametrize("pattern", ["reset_before_use", "mid_epoch"])
def test_process_path_equals_thread_path(rec_files, device_augment,
                                         pattern):
    path, _ = rec_files
    kw = dict(path_imgrec=path, data_shape=SHAPE, batch_size=8,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=36,
              mean_r=120.0, std_r=60.0, seed=11,
              device_augment=device_augment)

    def run(procs):
        it = mx.io.ImageRecordIter(preprocess_processes=procs,
                                   pipeline_timeout=TIMEOUT, **kw)
        try:
            if pattern == "reset_before_use":
                it.reset()
            else:
                it.next()
                it.next()
                it.reset()
            return _epochs(it, 2, with_aug=device_augment)
        finally:
            it.close()

    _same(run(2), run(0))
    assert not [f for f in os.listdir("/dev/shm") if f.startswith(
        f"mxt_io_{os.getpid()}_")]


def test_device_augment_batches_match_jax(rec_files):
    """The uint8 canvas and the flips/crops equal the JAX package's; the
    prologue itself is held in ``test_torch_image.py``."""
    path, _ = rec_files
    kw = dict(path_imgrec=path, data_shape=SHAPE, batch_size=8,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=40,
              seed=4, device_augment=True)
    it = mx.io.ImageRecordIter(**kw)
    jit = jmx.io.ImageRecordIter(**kw)
    _same(_epochs(it, 1, True), _epochs(jit, 1, True))
    assert it.provide_data[0].dtype == np.uint8
    assert it.augmenter.out_hw == (32, 32)


def test_killed_worker_is_a_bounded_error(rec_files):
    path, _ = rec_files
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=SHAPE,
                               batch_size=4, preprocess_processes=2,
                               pipeline_timeout=TIMEOUT)
    try:
        it.next()
        victim = it._pipeline._procs[1]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=TIMEOUT)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="died"):
            # the dead worker may have finished this epoch's batches; the
            # next epoch gives it more
            for _ in range(3):
                for _ in it:
                    pass
                it.reset()
        assert time.perf_counter() - t0 < TIMEOUT
        with pytest.raises(RuntimeError, match="died"):
            it.next()               # sticky
    finally:
        it.close()


def test_respawned_worker_keeps_the_epoch(rec_files):
    """``worker_respawn=True``: a killed worker is replaced, its batches
    are decoded again, and the epoch equals the thread path's."""
    path, _ = rec_files
    kw = dict(path_imgrec=path, data_shape=SHAPE, batch_size=4,
              shuffle=True, rand_mirror=True, seed=8)
    want = _epochs(mx.io.ImageRecordIter(**kw), 1)
    it = mx.io.ImageRecordIter(preprocess_processes=2, worker_respawn=True,
                               pipeline_timeout=TIMEOUT, **kw)
    try:
        first = it.next()
        os.kill(it._pipeline._procs[0].pid, signal.SIGKILL)
        got = [[first.data[0].asnumpy(), first.label[0].asnumpy(),
                first.pad]]
        got += [[b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad]
                for b in it]
        _same(got, want)
        assert it._pipeline.workers_alive
    finally:
        it.close()


def test_stalled_pool_times_out(rec_files):
    """A worker that hangs (stopped by SIGSTOP) ends in the pipeline's
    timeout, not a hang."""
    path, _ = rec_files
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=SHAPE,
                               batch_size=4, preprocess_processes=1,
                               pipeline_timeout=1)
    try:
        it.next()
        p = it._pipeline._procs[0]
        os.kill(p.pid, signal.SIGSTOP)
        try:
            with pytest.raises(RuntimeError, match="stalled"):
                for _ in range(3):
                    for _ in it:
                        pass
                    it.reset()
        finally:
            os.kill(p.pid, signal.SIGCONT)
    finally:
        it.close()


def _shm_names(prefix):
    """This process's ``/dev/shm`` entries whose names start with
    ``prefix`` (another test process's rings are not this test's)."""
    if not os.path.isdir("/dev/shm"):
        return []
    return [f for f in os.listdir("/dev/shm")
            if f.startswith(prefix) and f"_{os.getpid()}_" in f]


def test_port_rings_do_not_use_the_reference_shm_tag(rec_files):
    """The JAX package's leak check (``tests/test_io_pipeline.py``) fails
    on any ``/dev/shm`` name starting with ``mxio``, so the port's rings
    must never take that tag, or a port test holding a live ring makes the
    reference's tests fail when both run at once."""
    from mxnet_tpu_torch.io.shm_ring import ShmRing
    path, _ = rec_files
    ring = ShmRing(2, 4096)
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=SHAPE,
                               batch_size=4, preprocess_processes=1,
                               pipeline_timeout=TIMEOUT)
    try:
        it.next()
        pool_ring = it._pipeline.ring
        assert ring.name.startswith("mxt_io_")
        assert pool_ring.name.startswith("mxt_io_")
        assert _shm_names("mxt_io_"), "the live rings are not in /dev/shm"
        assert not _shm_names("mxio"), _shm_names("mxio")
    finally:
        it.close()
        ring.destroy()
    assert not _shm_names("mxt_io_")


def test_zero_copy_batches_alias_the_slot(rec_files):
    path, _ = rec_files
    kw = dict(path_imgrec=path, data_shape=SHAPE, batch_size=4, seed=2)
    it = mx.io.ImageRecordIter(preprocess_processes=1, ring_slots=2,
                               zero_copy_batches=True,
                               pipeline_timeout=TIMEOUT, **kw)
    ref = mx.io.ImageRecordIter(**kw)
    try:
        b0 = it.next()
        first = b0.data[0].asnumpy()
        np.testing.assert_array_equal(first, ref.next().data[0].asnumpy())
        for _ in range(2):
            it.next()
        # the slot was refilled: the zero-copy view no longer holds batch 0
        assert not np.array_equal(b0.data[0].asnumpy(), first)
    finally:
        it.close()


def test_prefetching_iters_give_the_iterators_batches(rec_files):
    path, _ = rec_files
    kw = dict(path_imgrec=path, data_shape=SHAPE, batch_size=8,
              shuffle=True, rand_mirror=True, seed=7)
    want = _epochs(mx.io.ImageRecordIter(**kw))
    pre = mx.io.PrefetchingIter(mx.io.ImageRecordIter(**kw))
    _same(_epochs(pre), want)
    # iterating a DevicePrefetchIter resets the iterator it wraps first
    ref = mx.io.ImageRecordIter(**kw)
    ref.reset()
    want = _epochs(ref)
    staged = mx.io.DevicePrefetchIter(mx.io.ImageRecordIter(**kw),
                                      ctx=mx.cpu())
    got = []
    for _ in range(2):
        for b in staged:
            assert b.data[0].context == mx.cpu()
            got.append([b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad])
    _same(got, want)


def test_device_prefetch_iter_errors_and_mid_epoch_reset():
    class Boom(mx.io.DataIter):
        def __init__(self, fail_at):
            super().__init__(2)
            self.fail_at, self.i = fail_at, 0

        def reset(self):
            self.i = 0

        def next(self):
            self.i += 1
            if self.i == self.fail_at:
                raise ValueError("decode failed")
            if self.i > 4:
                raise StopIteration
            return mx.io.DataBatch([mx.nd.array([self.i], ctx=mx.cpu())],
                                   [mx.nd.array([0], ctx=mx.cpu())])

    it = mx.io.DevicePrefetchIter(Boom(3), ctx=mx.cpu())
    it.reset()
    assert next(it).data[0].asscalar() == 1
    assert next(it).data[0].asscalar() == 2
    with pytest.raises(ValueError, match="decode failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    ok = mx.io.DevicePrefetchIter(Boom(0), ctx=mx.cpu(), depth=1)
    ok.reset()
    next(ok)
    ok.reset()                                  # mid-epoch
    assert [b.data[0].asscalar() for b in ok] == [1, 2, 3, 4]
    seen = mx.io.DevicePrefetchIter(Boom(0), stage_fn=lambda b: "staged")
    assert list(seen) == ["staged"] * 4


def test_array_iterators_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    data = rng.rand(10, 4).astype("float32")
    label = rng.randint(0, 3, 10).astype("float32")
    dcsv, lcsv = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dcsv, data, delimiter=",")
    np.savetxt(lcsv, label, delimiter=",")
    svm = str(tmp_path / "d.svm")
    with open(svm, "w") as f:
        for row, lab in zip(data, label):
            f.write(f"{lab:g} " + " ".join(f"{i}:{v:.6f}" for i, v in
                                           enumerate(row) if v > 0.3)
                    + "\n")
    imgs, labs = str(tmp_path / "i-idx3"), str(tmp_path / "l-idx1")
    pix = rng.randint(0, 256, (9, 5, 6)).astype("uint8")
    with open(imgs, "wb") as f:
        f.write(np.array([0x0803, 9, 5, 6], ">u4").tobytes() + pix.tobytes())
    with open(labs, "wb") as f:
        f.write(np.array([0x0801, 9], ">u4").tobytes()
                + rng.randint(0, 10, 9).astype("uint8").tobytes())
    cases = [
        ("CSVIter", dict(data_csv=dcsv, data_shape="(4,)", label_csv=lcsv,
                         batch_size=4, shuffle=True)),
        ("CSVIter", dict(data_csv=dcsv, data_shape=(2, 2), batch_size=3,
                         round_batch=False, num_parts=2, part_index=1)),
        ("LibSVMIter", dict(data_libsvm=svm, data_shape=(4,),
                            batch_size=4)),
        ("MNISTIter", dict(image=imgs, label=labs, batch_size=4, seed=3,
                           silent=True)),
        ("MNISTIter", dict(image=imgs, label=labs, batch_size=4,
                           flat=True, shuffle=False, silent=True)),
    ]
    for name, kw in cases:
        got = _epochs(getattr(mx.io, name)(**kw), 3)
        want = _epochs(getattr(jmx.io, name)(**kw), 3)
        _same(got, want)


def test_shard_sampler_and_from_mesh():
    s = mx.io.RecordShardSampler(3, 2)
    assert s.shard(10) == slice(8, 10)
    with pytest.raises(ValueError):
        mx.io.RecordShardSampler(2, 2)
    with pytest.raises(NotImplementedError, match="item 9"):
        mx.io.RecordShardSampler.from_mesh()
