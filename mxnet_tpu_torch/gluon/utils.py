"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py:21-145``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``
and ``shape_is_known``.  ``download`` fetches nothing: the port needs no
network, so it returns a file that is already there and raises
otherwise."""
from __future__ import annotations

import hashlib
import math
import os
import warnings

import torch

from .. import ndarray as nd
from ..context import as_device
from ..ndarray.ndarray import NDArray, to_device

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known"]


def _bounds(shape, num_slice, batch_axis, even_split):
    """The (begin, end) of each slice of :func:`split_data`."""
    size = shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's multiple of {num_slice} or set even_split=False to "
            f"allow uneven partitioning of data.")
    if not even_split and size < num_slice:
        num_slice = size
    step = size // num_slice
    return [(i * step, (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` slices along ``batch_axis``
    (``utils.py:36``); the last takes the remainder unless
    ``even_split``."""
    bounds = _bounds(data.shape, num_slice, batch_axis, even_split)
    if batch_axis == 0:
        return [data[lo:hi] for lo, hi in bounds]
    return [nd.slice_axis(data, axis=batch_axis, begin=lo, end=hi)
            for lo, hi in bounds]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of ``data`` on each context of ``ctx_list``
    (``utils.py:84``).  A host batch (a CPU NDArray, pinned by the data
    iterators) goes slice by slice straight from its memory, each copy
    ``non_blocking`` from pinned memory to a GPU."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    src = data._data
    if src.device.type == "cpu":
        bounds = _bounds(data.shape, len(ctx_list), batch_axis, even_split)
        return [NDArray(to_device(src.narrow(batch_axis, lo, hi - lo),
                                  as_device(ctx)))
                for (lo, hi), ctx in zip(bounds, ctx_list)]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float when
    ``check_isfinite``, which warns on a non-finite norm; else an
    NDArray) (``utils.py:115``)."""
    if not arrays:
        raise AssertionError("clip_global_norm takes at least one array")
    device = arrays[0]._data.device
    total = torch.sqrt(sum((a._data.detach().float() ** 2).sum().to(device)
                           for a in arrays))
    if check_isfinite:
        value = float(total)
        if not math.isfinite(value):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
    scale = torch.clamp(max_norm / (total + 1e-8), max=1.0)
    for a in arrays:
        a *= NDArray(scale.to(a._data.device, a._data.dtype))
    return value if check_isfinite else NDArray(total)


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash`` (``utils.py:172``)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """MXNet's ``download``, without a network: the file at ``path`` (or
    the URL's last component) when it is there (and matches
    ``sha1_hash``), else ``RuntimeError``; nothing is fetched."""
    fname = url.split("/")[-1] if path is None else os.path.expanduser(path)
    if path is not None and os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])
    if not overwrite and os.path.exists(fname) and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise RuntimeError(f"cannot download {url}: the port fetches nothing "
                       f"over the network. Place the file at {fname}.")


def shape_is_known(shape):
    """True when no dimension of ``shape`` is unknown (0, None or -1)."""
    if shape is None:
        return False
    return all(d not in (0, None, -1) for d in shape)
