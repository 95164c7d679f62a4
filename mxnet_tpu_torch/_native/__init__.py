"""The port's loader of the native RecordIO reader and JPEG decoder.

Counterpart of ``mxnet_tpu/_native/__init__.py``, over the same C sources:
``src/io/recordio_reader.cc`` (RecordIO framing scan and batched reads) and
``src/io/jpeg_decode.cc`` (libjpeg decode, resize, crop, mirror and
normalise on C++ threads).  Both are host code with a flat C interface,
built unchanged with ``g++`` at first use into ``build/mxnet_tpu_torch/``
beside the CUDA library (``ops/_build.py``), under a name that carries a
hash of the sources and flags, and loaded with :mod:`ctypes`.

The decoder links only where ``-ljpeg`` links.  When it does not, a
``.nojpeg`` marker beside the library records the linker's last line, the
library holds the reader alone, and images decode through cv2 (as MXNet
builds without libjpeg-turbo do).  When ``g++`` itself fails, records are
read by plain Python IO.  Neither choice is silent: :func:`status` names
the reader and the decoder in use and the reason for a fallback, and
``ImageRecordIter.reader``/``.decoder`` report them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["load", "available", "decode_available", "decode_canvas_available",
           "status", "build_index", "read_record", "read_batch",
           "decode_batch", "decode_batch_u8", "LIB_DIR"]

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "src" / "io" / "recordio_reader.cc"
_SRC_JPEG = _ROOT / "src" / "io" / "jpeg_decode.cc"
LIB_DIR = _ROOT / "build" / "mxnet_tpu_torch"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
_status = {"reader": "not loaded", "decoder": "not loaded"}


def _digest():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in (_SRC, _SRC_JPEG):
        if src.exists():
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _last_line(text):
    lines = [ln.strip() for ln in (text or "").splitlines() if ln.strip()]
    return lines[-1][:200] if lines else "no output"


def _build(so):
    """Link the reader with the decoder and ``-ljpeg``; failing that, the
    reader alone and a ``.nojpeg`` marker holding the linker's reason.
    Private file names, then an atomic rename: a build in another process
    never loads a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    marker = so.with_name(so.name + ".nojpeg")
    if _SRC_JPEG.exists():
        r = subprocess.run(["g++", *_FLAGS, str(_SRC), str(_SRC_JPEG), "-o",
                            str(tmp), "-ljpeg"], capture_output=True,
                           text=True)
        if r.returncode == 0:
            os.replace(tmp, so)
            marker.unlink(missing_ok=True)
            return
        mtmp = marker.with_name(f"{marker.name}.{os.getpid()}.tmp")
        mtmp.write_text(f"g++ -ljpeg failed: {_last_line(r.stderr)}\n")
        os.replace(mtmp, marker)
    r = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_SRC.name}: "
                           f"{_last_line(r.stderr)}")
    os.replace(tmp, so)


def _bind(lib):
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rio_build_index.restype = ctypes.c_int64
    lib.rio_build_index.argtypes = [ctypes.c_char_p, ctypes.POINTER(u64p),
                                    ctypes.POINTER(u64p)]
    lib.rio_free.argtypes = [ctypes.c_void_p]
    lib.rio_read_record.restype = ctypes.c_int64
    lib.rio_read_record.argtypes = [ctypes.c_char_p, ctypes.c_uint64, u8p,
                                    ctypes.c_uint64]
    lib.rio_read_batch.restype = ctypes.c_int64
    lib.rio_read_batch.argtypes = [ctypes.c_char_p, u64p, ctypes.c_int64,
                                   u8p, ctypes.c_uint64, u64p]
    if hasattr(lib, "jpg_decode_batch"):
        lib.jpg_decode_batch.restype = ctypes.c_int64
        lib.jpg_decode_batch.argtypes = [
            u8p, u64p, u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, f32p, u8p, f32p, f32p, ctypes.c_float,
            ctypes.c_int, f32p]
    if hasattr(lib, "jpg_decode_batch_u8"):
        lib.jpg_decode_batch_u8.restype = ctypes.c_int64
        lib.jpg_decode_batch_u8.argtypes = [
            u8p, u64p, u64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p]
    return lib


def load():
    """The ctypes library, built on the first call; ``None`` when ``g++``
    cannot build it (:func:`status` then says why)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = LIB_DIR / f"libmxnet_tpu_torch_io_{_digest()}.so"
        try:
            if not so.exists():
                _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                # a library built on another machine (a copied build/
                # directory) may link a libjpeg this one lacks: rebuild
                _build(so)
                lib = ctypes.CDLL(str(so))
            _lib = _bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _status.update(reader=f"python ({e})",
                           decoder="cv2 (no native library)")
            return None
        _status["reader"] = "native"
        if hasattr(_lib, "jpg_decode_batch"):
            _status["decoder"] = "native"
        else:
            marker = so.with_name(so.name + ".nojpeg")
            why = marker.read_text().strip() if marker.exists() else \
                "the library has no decoder"
            _status["decoder"] = f"cv2 ({why})"
        return _lib


def status():
    """``{"reader": ..., "decoder": ...}``: ``"native"``, or the fallback
    (``"python (...)"``, ``"cv2 (...)"``) with its reason.  Loads (and
    builds) the library."""
    load()
    return dict(_status)


def available():
    return load() is not None


def decode_available():
    """True when the library carries the libjpeg decode path."""
    lib = load()
    return lib is not None and hasattr(lib, "jpg_decode_batch")


def decode_canvas_available():
    """True when the library carries the uint8 canvas decoder."""
    lib = load()
    return lib is not None and hasattr(lib, "jpg_decode_batch_u8")


def build_index(path):
    """Scan a .rec file -> (offsets, lengths) uint64 arrays, or ``None``
    without the library."""
    lib = load()
    if lib is None:
        return None
    off = ctypes.POINTER(ctypes.c_uint64)()
    lens = ctypes.POINTER(ctypes.c_uint64)()
    n = lib.rio_build_index(str(path).encode(), ctypes.byref(off),
                            ctypes.byref(lens))
    if n < 0:
        raise IOError(f"native recordio scan failed on {path} (code {n})")
    try:
        offsets = np.ctypeslib.as_array(off, shape=(n,)).copy() if n else \
            np.zeros(0, np.uint64)
        lengths = np.ctypeslib.as_array(lens, shape=(n,)).copy() if n else \
            np.zeros(0, np.uint64)
    finally:
        lib.rio_free(off)
        lib.rio_free(lens)
    return offsets, lengths


def read_record(path, offset, length_hint):
    """One logical record at ``offset`` -> bytes."""
    lib = load()
    if lib is None:
        return None
    cap = max(int(length_hint), 4096)
    buf = (ctypes.c_uint8 * cap)()
    n = lib.rio_read_record(str(path).encode(), int(offset), buf, cap)
    if n == -4:  # a multipart record longer than the hint
        cap *= 8
        buf = (ctypes.c_uint8 * cap)()
        n = lib.rio_read_record(str(path).encode(), int(offset), buf, cap)
    if n < 0:
        raise IOError(f"native recordio read failed (code {n})")
    return bytes(bytearray(buf[:n]))


def read_batch(path, offsets, lengths):
    """Many records in one native call -> list of bytes."""
    lib = load()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    total = int(np.asarray(lengths, dtype=np.uint64).sum())
    out = np.empty(max(total, 1), dtype=np.uint8)
    out_lens = np.zeros(len(offsets), dtype=np.uint64)
    n = lib.rio_read_batch(
        str(path).encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(offsets), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        total, out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if n < 0:
        raise IOError(f"native recordio batch read failed (code {n})")
    recs, pos = [], 0
    for ln in out_lens:
        ln = int(ln)
        recs.append(out[pos:pos + ln].tobytes())
        pos += ln
    return recs


def _pack_blob(payloads):
    """Byte payloads as one contiguous (blob, offsets, lengths) triple."""
    n = len(payloads)
    lengths = np.asarray([len(p) for p in payloads], dtype=np.uint64)
    offsets = np.zeros(n, dtype=np.uint64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    blob = np.empty(int(lengths.sum()), dtype=np.uint8)
    for i, p in enumerate(payloads):
        blob[int(offsets[i]):int(offsets[i]) + len(p)] = \
            np.frombuffer(p, dtype=np.uint8)
    return blob, offsets, lengths


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_batch(payloads, out_hw, resize=-1, crop_xy=None, mirror=None,
                 mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), scale=1.0,
                 n_threads=4, out=None):
    """Decode and augment JPEG byte strings into float32 CHW RGB (shorter
    edge ``resize``, crop at ``crop_xy`` fractions or the centre, mirror,
    ``(x - mean) / std * scale``).  ``out``: a contiguous float32 (n, 3,
    H, W) destination (a pinned tensor's or a ring slot's memory).
    ``None`` without the decoder."""
    lib = load()
    if lib is None or not hasattr(lib, "jpg_decode_batch"):
        return None
    n = len(payloads)
    h, w = int(out_hw[0]), int(out_hw[1])
    blob, offsets, lengths = _pack_blob(payloads)
    crops = np.full((n, 2), -1.0, dtype=np.float32) if crop_xy is None \
        else np.ascontiguousarray(crop_xy, dtype=np.float32)
    flips = np.zeros(n, dtype=np.uint8) if mirror is None else \
        np.ascontiguousarray(mirror, dtype=np.uint8)
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    std = np.ascontiguousarray(std, dtype=np.float32)
    if out is None:
        out = np.empty((n, 3, h, w), dtype=np.float32)
    elif out.dtype != np.float32 or out.shape != (n, 3, h, w) \
            or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"decode_batch out buffer must be contiguous "
                         f"float32 {(n, 3, h, w)}, got {out.dtype} "
                         f"{out.shape}")
    rc = lib.jpg_decode_batch(
        _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_uint64),
        _ptr(lengths, ctypes.c_uint64), n, int(resize), h, w,
        _ptr(crops, ctypes.c_float), _ptr(flips, ctypes.c_uint8),
        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float), float(scale),
        int(n_threads), _ptr(out, ctypes.c_float))
    if rc < 0:
        raise IOError(f"native jpeg decode failed on image {-rc - 1}")
    return out


def decode_batch_u8(payloads, out_hw, n_threads=1, out=None):
    """Decode JPEGs to a fixed uint8 CHW canvas (whole-image bilinear
    resize, no augmentation: that is the device prologue).  ``None``
    without the canvas decoder."""
    lib = load()
    if lib is None or not hasattr(lib, "jpg_decode_batch_u8"):
        return None
    n = len(payloads)
    h, w = int(out_hw[0]), int(out_hw[1])
    blob, offsets, lengths = _pack_blob(payloads)
    if out is None:
        out = np.empty((n, 3, h, w), dtype=np.uint8)
    elif out.dtype != np.uint8 or out.shape != (n, 3, h, w) \
            or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"decode_batch_u8 out buffer must be contiguous "
                         f"uint8 {(n, 3, h, w)}, got {out.dtype} "
                         f"{out.shape}")
    rc = lib.jpg_decode_batch_u8(
        _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_uint64),
        _ptr(lengths, ctypes.c_uint64), n, h, w, int(n_threads),
        _ptr(out, ctypes.c_uint8))
    if rc < 0:
        raise IOError(f"native jpeg canvas decode failed on image "
                      f"{-rc - 1}")
    return out
