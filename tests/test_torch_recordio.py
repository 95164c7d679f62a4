"""RecordIO in the port against the JAX package, on the CPU.

``.rec`` and ``.idx`` files written by either package read in the other,
record for record; ``pack``, ``pack_img`` and the framing give the same
bytes; the native loader builds ``src/io/recordio_reader.cc`` into the
ignored ``build/`` directory and reads what Python reads.
"""
import numpy as np
import pytest

from mxnet_tpu import recordio as jrec

from mxnet_tpu_torch import _native
from mxnet_tpu_torch import recordio as rec

N = 24


def _payloads(rng):
    # lengths around the 4-byte padding boundary, an empty record and one
    # long enough to need several reads
    sizes = [0, 1, 2, 3, 4, 5, 7, 8, 9] + list(rng.randint(10, 3000, N - 10))
    sizes.append(70_000)
    return [rng.bytes(int(s)) for s in sizes]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rec_files_read_in_the_other_package(tmp_path, writer):
    rng = np.random.RandomState(0)
    payloads = _payloads(rng)
    path = str(tmp_path / "a.rec")
    w_mod, r_mod = (rec, jrec) if writer == "port" else (jrec, rec)
    w = w_mod.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    r = r_mod.MXRecordIO(path, "r")
    got = [r.read() for _ in payloads]
    assert r.read() is None
    assert got == payloads
    # the other writer makes the same bytes
    other = str(tmp_path / "b.rec")
    w2 = r_mod.MXRecordIO(other, "w")
    for p in payloads:
        w2.write(p)
    w2.close()
    assert open(path, "rb").read() == open(other, "rb").read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_indexed_files_read_in_the_other_package(tmp_path, writer):
    rng = np.random.RandomState(1)
    payloads = _payloads(rng)
    idx, path = str(tmp_path / "a.idx"), str(tmp_path / "a.rec")
    w_mod, r_mod = (rec, jrec) if writer == "port" else (jrec, rec)
    w = w_mod.MXIndexedRecordIO(idx, path, "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    r = r_mod.MXIndexedRecordIO(idx, path, "r")
    assert list(r.keys) == list(range(len(payloads)))
    for i in rng.permutation(len(payloads)):
        assert r.read_idx(int(i)) == payloads[i]
    ridx = str(tmp_path / "b.idx")
    w2 = r_mod.MXIndexedRecordIO(ridx, str(tmp_path / "b.rec"), "w")
    for i, p in enumerate(payloads):
        w2.write_idx(i, p)
    w2.close()
    assert open(idx).read() == open(ridx).read()


@pytest.mark.parametrize("label", [3.0, 7, [1.0, 2.5, -3.0]])
def test_pack_and_unpack_bytes_equal(label):
    h = rec.IRHeader(0, label, 7, 11)
    s = rec.pack(h, b"payload")
    assert s == jrec.pack(jrec.IRHeader(0, label, 7, 11), b"payload")
    h2, payload = rec.unpack(s)
    j2, jpayload = jrec.unpack(s)
    assert payload == jpayload == b"payload"
    assert (h2.flag, h2.id, h2.id2) == (j2.flag, j2.id, j2.id2)
    np.testing.assert_array_equal(np.asarray(h2.label), np.asarray(j2.label))


@pytest.mark.parametrize("fmt,quality", [(".jpg", 85), (".jpg", 95),
                                         (".png", 3)])
def test_pack_img_bytes_equal_and_decode(fmt, quality):
    img = (np.random.RandomState(2).rand(32, 40, 3) * 255).astype(np.uint8)
    h = rec.IRHeader(0, 4.0, 1, 0)
    s = rec.pack_img(h, img, quality=quality, img_fmt=fmt)
    assert s == jrec.pack_img(jrec.IRHeader(0, 4.0, 1, 0), img,
                              quality=quality, img_fmt=fmt)
    h2, dec = rec.unpack_img(s, iscolor=1)
    _, jdec = jrec.unpack_img(s, iscolor=1)
    assert h2.label == 4.0
    np.testing.assert_array_equal(dec, jdec)
    if fmt == ".png":
        np.testing.assert_array_equal(dec, img)


def test_pickled_reader_reopens_and_the_original_stays_open(tmp_path):
    """A ``DataLoader`` pickles its dataset once per spawned worker: every
    copy reads, and so does the original."""
    import pickle
    idx, path = str(tmp_path / "a.idx"), str(tmp_path / "a.rec")
    w = rec.MXIndexedRecordIO(idx, path, "w")
    for i in range(3):
        w.write_idx(i, b"r%d" % i)
    w.close()
    r = rec.MXIndexedRecordIO(idx, path, "r")
    copies = [pickle.loads(pickle.dumps(r)) for _ in range(2)]
    for c in copies + [r]:
        assert c.read_idx(2) == b"r2" and c.read_idx(0) == b"r0"


def test_native_reader_builds_into_build_dir_and_reads(tmp_path):
    """The loader builds the unchanged C source into build/mxnet_tpu_torch/
    and its scan and batched reads give Python's records."""
    status = _native.status()
    assert status["reader"] == "native", status
    assert status["decoder"] == "native" or \
        status["decoder"].startswith("cv2 ("), status
    libs = list(_native.LIB_DIR.glob("libmxnet_tpu_torch_io_*.so"))
    assert libs, _native.LIB_DIR
    rng = np.random.RandomState(3)
    payloads = _payloads(rng)
    path = str(tmp_path / "a.rec")
    w = rec.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    offsets, lengths = _native.build_index(path)
    assert len(offsets) == len(payloads)
    np.testing.assert_array_equal(lengths, [len(p) for p in payloads])
    sel = rng.permutation(len(payloads))[:10]
    got = _native.read_batch(path, offsets[sel], lengths[sel])
    assert got == [payloads[i] for i in sel]
    assert _native.read_record(path, offsets[-1], lengths[-1]) == \
        payloads[-1]
