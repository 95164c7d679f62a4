"""MXNet's binary NDArray-list format (``.params``) on torch tensors.

The port's own copy of ``mxnet_tpu/ndarray/ndarray.py:960-1143``, itself the
reference's dmlc stream (``src/ndarray/ndarray.cc:1584-1860``): a list magic,
the arrays, then the names.  It is the weight bridge between the JAX package
(``Block.save_parameters``) and the port, and files load in stock MXNet.

Reading takes every header the reference reads: V2 and V3 arrays (a V2
0-d header is the legacy "empty array" sentinel and nothing follows it), the
V1 and pre-V1 legacy headers, and row-sparse/CSR payloads, which are made
dense.  Writing uses one magic for the whole file: V3 when some array is
0-d (V2 cannot hold one), V2 otherwise.  The JAX writer mixes the two within
a file (V3 for 0-d arrays only), which the original MXNet cannot load; the
port does not copy that.
"""
from __future__ import annotations

import io
import struct

import numpy as np
import torch

__all__ = ["save", "load", "load_frombuffer"]

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA
_TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
               4: np.int32, 5: np.int8, 6: np.int64}
_FLAG_OF = {np.dtype(v): k for k, v in _TYPE_FLAGS.items()}


def _as_numpy(t):
    """``t`` as a numpy array with a type flag.  bfloat16, which has no
    flag, is written as its exact float32 values (flag 0), as the JAX
    package's writer does (``mxnet_tpu/ndarray/ndarray.py:981-995``); it
    reads back as float32."""
    if isinstance(t, torch.Tensor):
        if t.dtype is torch.bool or t.is_complex():
            raise TypeError(f"the .params format has no type flag for "
                            f"{t.dtype}")
        if t.dtype is torch.bfloat16:
            t = t.float()
        t = t.detach().cpu().numpy()
    a = np.asarray(t, order="C")       # keeps 0-d arrays 0-d
    if np.dtype(a.dtype) not in _FLAG_OF:
        raise TypeError(f"the .params format has no type flag for "
                        f"{a.dtype}; it holds {sorted(map(str, _FLAG_OF))}")
    return a


def _write_array(f, a, magic):
    f.write(struct.pack("<I", magic))
    f.write(struct.pack("<i", 0))                      # dense storage
    f.write(struct.pack("<I", a.ndim))
    f.write(struct.pack(f"<{a.ndim}q", *a.shape))
    f.write(struct.pack("<ii", 1, 0))                  # context: cpu(0)
    f.write(struct.pack("<i", _FLAG_OF[np.dtype(a.dtype)]))
    f.write(a.tobytes())


def save(fname, data):
    """Write a tensor, a list of tensors or a ``{name: tensor}`` dict (CPU
    or CUDA; numpy arrays are taken too) to ``fname``."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        names = list(data)
        arrays = [_as_numpy(data[k]) for k in names]
    else:
        names = []
        arrays = [_as_numpy(a) for a in data]
    magic = _V3_MAGIC if any(a.ndim == 0 for a in arrays) else _V2_MAGIC
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_array(f, a, magic)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def _read(f, fmt):
    size = struct.calcsize(fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise ValueError("truncated .params stream")
    return struct.unpack(fmt, buf)


def _read_shape(f, int64_dims=True):
    (ndim,) = _read(f, "<I")
    return _read(f, f"<{ndim}{'q' if int64_dims else 'I'}")


def _read_data(f, flag, shape):
    dt = np.dtype(_TYPE_FLAGS[flag])
    n = int(np.prod(shape)) if shape else 1
    buf = f.read(n * dt.itemsize)
    if len(buf) != n * dt.itemsize:
        raise ValueError("truncated .params stream")
    return np.frombuffer(buf, dtype=dt).reshape(shape).copy()


def _read_array(f):
    (magic,) = _read(f, "<I")
    if magic in (_V2_MAGIC, _V3_MAGIC):
        (stype,) = _read(f, "<i")
        n_aux = {1: 1, 2: 2}.get(stype, 0)   # row_sparse: idx; csr: 2
        storage_shape = _read_shape(f) if n_aux else None
        shape = _read_shape(f)
        if len(shape) == 0 and magic == _V2_MAGIC:
            return np.zeros((), np.float32)   # legacy empty sentinel
        _read(f, "<ii")                       # context
        (flag,) = _read(f, "<i")
        aux = [(_read(f, "<i")[0], _read_shape(f)) for _ in range(n_aux)]
        data = _read_data(f, flag, storage_shape if n_aux else shape)
        if not n_aux:
            return data
        auxes = [_read_data(f, aflag, ashape) for aflag, ashape in aux]
        dense = np.zeros(shape, dtype=data.dtype)
        if stype == 1:
            dense[auxes[0].astype(np.int64)] = data
        else:
            indptr, indices = auxes
            for r in range(shape[0]):
                for k in range(int(indptr[r]), int(indptr[r + 1])):
                    dense[r, int(indices[k])] = data[k]
        return dense
    if magic == _V1_MAGIC:
        shape = _read_shape(f, int64_dims=False)
    else:                                     # pre-V1: the magic is ndim
        shape = _read(f, f"<{magic}I")
    if len(shape) == 0:
        return np.zeros((), np.float32)
    _read(f, "<ii")
    (flag,) = _read(f, "<i")
    return _read_data(f, flag, shape)


def _load_stream(f):
    head = f.read(16)
    if len(head) != 16 or struct.unpack("<QQ", head)[0] != _LIST_MAGIC:
        raise ValueError("not an MXNet NDArray list (.params) stream")
    (count,) = _read(f, "<Q")
    arrays = [torch.from_numpy(_read_array(f)) for _ in range(count)]
    (n_names,) = _read(f, "<Q")
    names = []
    for _ in range(n_names):
        (ln,) = _read(f, "<Q")
        names.append(f.read(ln).decode("utf-8"))
    return dict(zip(names, arrays)) if names else arrays


def load(fname):
    """``{name: tensor}`` (or a list when the file has no names), CPU
    tensors with the file's dtypes."""
    with open(fname, "rb") as f:
        return _load_stream(f)


def load_frombuffer(buf):
    """:func:`load` from bytes in memory."""
    return _load_stream(io.BytesIO(buf))
