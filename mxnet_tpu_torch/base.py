"""Dtype names and codes, and MXNet's string-attribute parsers (the port's
copy of ``mxnet_tpu/base.py``).

Ops take MXNet's attribute forms: ``"(2, 2)"``, ``"True"``, ``"float32"``,
as user scripts and Symbol JSON pass them.

Dtypes.  ``np_dtype`` normalises a user's dtype to a numpy dtype, as the
JAX package does, except bfloat16: numpy has no bfloat16 of its own (the
JAX package borrows ``ml_dtypes``'), so here it is ``torch.bfloat16``
itself, exported as :data:`bfloat16`.  ``torch_dtype`` maps any of those
forms to the torch dtype a tensor is made with, and ``dtype_of`` maps a
torch dtype back to what ``NDArray.dtype`` reports: the numpy dtype, or
:data:`bfloat16`.
"""
from __future__ import annotations

import ast

import numpy as np
import torch

__all__ = ["MXNetError", "bfloat16", "np_dtype", "torch_dtype", "dtype_of",
           "dtype_code", "parse_bool", "parse_tuple", "parse_int",
           "parse_float"]


class MXNetError(RuntimeError):
    """Error raised by framework routines (``mxnet_tpu/base.py:19``)."""


bfloat16 = torch.bfloat16

# mshadow's type codes, as the .params format and the JAX package use them
_DTYPE_NP_TO_MX = {
    np.dtype(np.float32): 0, np.dtype(np.float64): 1,
    np.dtype(np.float16): 2, np.dtype(np.uint8): 3, np.dtype(np.int32): 4,
    np.dtype(np.int8): 5, np.dtype(np.int64): 6, np.dtype(np.bool_): 7,
    bfloat16: 12,
}
_DTYPE_MX_TO_NP = {v: k for k, v in _DTYPE_NP_TO_MX.items()}
_TORCH_OF = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32, np.dtype(np.int8): torch.int8,
    np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool,
    np.dtype(np.int16): torch.int16,
}
_NP_OF = {v: k for k, v in _TORCH_OF.items()}


def np_dtype(dtype):
    """A user's dtype (str, numpy dtype or type, torch dtype, int code,
    ``None`` for float32) as a numpy dtype; bfloat16 as
    :data:`bfloat16`."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        return dtype_of(dtype)
    if isinstance(dtype, int) and not isinstance(dtype, bool):
        return _DTYPE_MX_TO_NP[dtype]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return bfloat16
    return np.dtype(dtype)


def torch_dtype(dtype):
    """The torch dtype for any form :func:`np_dtype` takes."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np_dtype(dtype)
    if dt is bfloat16:
        return bfloat16
    try:
        return _TORCH_OF[dt]
    except KeyError:
        raise TypeError(f"the port has no tensor type for {dt}") from None


def dtype_of(tdtype):
    """What ``NDArray.dtype`` reports for a tensor of torch dtype
    ``tdtype``: its numpy dtype, or :data:`bfloat16`."""
    if tdtype is bfloat16:
        return bfloat16
    try:
        return _NP_OF[tdtype]
    except KeyError:
        raise TypeError(f"no numpy dtype for {tdtype}") from None


def dtype_code(dtype) -> int:
    return _DTYPE_NP_TO_MX[np_dtype(dtype)]


def parse_bool(v, default=False):
    if v is None:
        return default
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    return str(v).strip().lower() in ("1", "true", "yes")


def parse_tuple(v, ndim=None, default=None):
    """``(2, 2)`` / ``[2, 2]`` / ``2`` / ``"(2,2)"`` -> a tuple of int; a
    single value repeats to ``ndim``."""
    if v is None:
        if default is None:
            return None
        v = default
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, np.integer)):
        v = (int(v),) * (ndim or 1)
    t = tuple(int(x) for x in v)
    if ndim is not None and len(t) == 1 and ndim > 1:
        t = t * ndim
    return t


def parse_int(v, default=None):
    if v is None:
        return default
    return int(v)


def parse_float(v, default=None):
    """A float; a tensor (a device scalar such as a traced learning rate)
    passes as it is."""
    if v is None:
        return default
    if isinstance(v, torch.Tensor):
        return v
    return float(v)
