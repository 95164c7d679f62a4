"""The device prologue of ``ImageRecordIter(device_augment=True)``: crop,
mirror, normalise and widen to float32 of a staged uint8 canvas batch, on
the batch's device (the port's counterpart of
``mxnet_tpu/image/device_augment.py``).

The JAX package compiles one ``jax.jit`` program per (shape, dtype).  Here
the prologue is ``ops.image_ops.image_augment``: one gather over computed
indices and one elementwise chain, run eagerly by torch.  The cache
contract is kept: ``compile_misses`` counts the distinct (shape, dtype)
entries seen (``io.augment_compile_miss`` on the telemetry bus), so a
steady state adds none.

An NDArray goes through ``nd.image.augment`` (the op table's entry) and
comes back an NDArray on its device; a tensor comes back a tensor on its
device; a numpy array is put on the current context first (the GPU unless
the caller runs under ``with mx.cpu():``), as the JAX package's ``jit``
runs it on the default device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import dtype_of
from ..context import as_device
from ..telemetry import bus as _tel

__all__ = ["DeviceAugmenter"]


def _rgb3(v, default):
    a = np.asarray(v if v is not None else default, dtype=np.float32)
    if a.ndim == 0:
        a = np.full(3, float(a), dtype=np.float32)
    assert a.shape == (3,), f"want 3 per-channel values, got {a.shape}"
    return a


class DeviceAugmenter:
    """Crop/flip/normalize/widen prologue for staged uint8 batches.

    ``out_hw``: the (H, W) crop target (the iterator's ``data_shape``
    spatial dims).  ``flips``/``crops`` are the per-batch arrays the
    iterator attaches as ``batch.augment_flip``/``batch.augment_crop``;
    they are data, so fresh randomness adds no cache entry.
    """

    def __init__(self, out_hw, mean=None, std=None, scale=1.0,
                 rand_crop=False, rand_mirror=False):
        self.out_hw = (int(out_hw[0]), int(out_hw[1]))
        self.mean = _rgb3(mean, 0.0)
        self.std = _rgb3(std, 1.0)
        self.scale = float(scale)
        self.rand_crop = bool(rand_crop)
        self.rand_mirror = bool(rand_mirror)
        self._seen = set()           # (shape, dtype) entries
        self.compile_misses = 0

    def _attrs(self):
        return dict(out_h=self.out_hw[0], out_w=self.out_hw[1],
                    mean_r=float(self.mean[0]), mean_g=float(self.mean[1]),
                    mean_b=float(self.mean[2]), std_r=float(self.std[0]),
                    std_g=float(self.std[1]), std_b=float(self.std[2]),
                    scale=self.scale, rand_crop=self.rand_crop)

    def _note(self, shape, dtype):
        key = (tuple(shape), str(dtype_of(dtype) if isinstance(
            dtype, torch.dtype) else np.dtype(dtype)))
        if key not in self._seen:
            self._seen.add(key)
            self.compile_misses += 1
            if _tel.enabled:
                _tel.count("io.augment_compile_miss")
                _tel.instant("io.augment_compile", shape=repr(key[0]),
                             dtype=key[1])
        if _tel.enabled:
            _tel.count("io.augment_batches")

    def __call__(self, data, flips=None, crops=None):
        """Augment one staged batch; NDArray in, NDArray out."""
        from ..ndarray import NDArray
        n = data.shape[0]
        flips = np.zeros(n, dtype=np.uint8) if flips is None else \
            np.asarray(flips, dtype=np.uint8)
        crops = np.zeros((n, 2), dtype=np.float32) if crops is None else \
            np.asarray(crops, dtype=np.float32)
        if isinstance(data, NDArray):
            from .. import nd
            self._note(data.shape, data.dtype)
            dev = data._data.device
            return nd.image.augment(
                data, NDArray(torch.from_numpy(flips).to(dev)),
                NDArray(torch.from_numpy(crops).to(dev)), **self._attrs())
        from ..ops.image_ops import image_augment
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data)).to(
                as_device(None))
        self._note(data.shape, data.dtype)
        return image_augment(data, torch.from_numpy(flips).to(data.device),
                             torch.from_numpy(crops).to(data.device),
                             **self._attrs())
