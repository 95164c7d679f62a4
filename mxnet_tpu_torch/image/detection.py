"""The detection input path (reference ``python/mxnet/image/detection.py``;
the port's copy of ``mxnet_tpu/image/detection.py``): augmenters that move
an image and its boxes together, and ``ImageDetIter``.

Label format (the reference's "object" layout): per image an (M, 4+)
array ``[cls, x1, y1, x2, y2, ...]`` with coordinates in [0, 1]; batches
pad with rows of ``label_pad_value`` (-1).  As in ``image.py``, this is
host work: images are CPU NDArrays, random draws come from Python's
``random``, and batches are host arrays (``io.host_array``), so the same
seeds give the JAX package's batches.
"""
from __future__ import annotations

import random

import numpy as np

from .. import io as io_mod
from .. import ndarray as nd
from ..io.io import host_array
from .image import (CastAug, ColorNormalizeAug, ImageIter, imresize,
                    resize_short)

__all__ = ["DetAugmenter", "DetHorizontalFlipAug", "DetRandomCropAug",
           "DetBorrowAug", "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Augmenter over (image, label) pairs (reference
    ``detection.py:DetAugmenter``)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only augmenter (reference ``detection.py:
    DetBorrowAug``)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and mirror its valid boxes' x1/x2 with probability
    ``p`` (reference ``detection.py:DetHorizontalFlipAug``)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            src = nd.flip(src, axis=1)
            out = label.copy()
            valid = out[:, 0] >= 0
            x1 = out[:, 1].copy()
            out[:, 1] = np.where(valid, 1.0 - label[:, 3], out[:, 1])
            out[:, 3] = np.where(valid, 1.0 - x1, out[:, 3])
            label = out
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop of at least ``min_scale`` of each side (the JAX
    package's simplification of the reference's min_object_covered
    sampler): boxes whose centre stays inside are re-normalised into the
    crop and clipped to it, the others are dropped (class -1); a crop that
    would keep no box is drawn again, up to ``max_trials`` times, else the
    image is left as it is."""

    def __init__(self, min_scale=0.6, max_trials=10):
        self.min_scale = min_scale
        self.max_trials = max_trials

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        for _ in range(self.max_trials):
            s = random.uniform(self.min_scale, 1.0)
            cw, ch = int(w * s), int(h * s)
            x0 = random.randint(0, w - cw)
            y0 = random.randint(0, h - ch)
            out = label.copy()
            kept = 0
            for i, row in enumerate(label):
                if row[0] < 0:
                    continue
                cx = (row[1] + row[3]) / 2 * w
                cy = (row[2] + row[4]) / 2 * h
                if x0 <= cx <= x0 + cw and y0 <= cy <= y0 + ch:
                    out[i, 1] = np.clip((row[1] * w - x0) / cw, 0, 1)
                    out[i, 2] = np.clip((row[2] * h - y0) / ch, 0, 1)
                    out[i, 3] = np.clip((row[3] * w - x0) / cw, 0, 1)
                    out[i, 4] = np.clip((row[4] * h - y0) / ch, 0, 1)
                    kept += 1
                else:
                    out[i, 0] = -1
            if kept:
                return src[y0:y0 + ch, x0:x0 + cw], out
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_mirror=False,
                       mean=None, std=None, min_object_covered=0.1,
                       **kwargs):
    """The standard detection augmenter list (reference
    ``detection.py:CreateDetAugmenter``)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(lambda img: resize_short(img, resize)))
    if rand_crop > 0:
        auglist.append(DetRandomCropAug())
    auglist.append(DetBorrowAug(
        lambda img: imresize(img, data_shape[2], data_shape[1])))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator over ``.rec`` packs whose record labels hold
    ``[header_width, obj_width, cls, x1, y1, x2, y2, ...]`` or plain
    ``(M*5,)`` box lists (reference ``detection.py:ImageDetIter``); each
    batch's label is ``(batch_size, max_objects, 5)``, padded with
    ``label_pad_value``."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imgidx=None, shuffle=False, aug_list=None,
                 label_width=-1, max_objects=8, label_pad_value=-1.0,
                 **kwargs):
        self._max_objects = max_objects
        self._label_pad_value = float(label_pad_value)
        super().__init__(batch_size, data_shape, path_imgrec=path_imgrec,
                         path_imgidx=path_imgidx, shuffle=shuffle,
                         aug_list=aug_list if aug_list is not None else [],
                         **kwargs)
        if aug_list is None:
            self.detauglist = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_mirror", "mean",
                         "std")})
        else:
            self.detauglist = aug_list

    @property
    def provide_label(self):
        return [io_mod.DataDesc("label",
                                (self.batch_size, self._max_objects, 5),
                                np.float32)]

    def _parse_label(self, raw):
        arr = np.ravel(np.asarray(raw, dtype=np.float32))
        if arr.size >= 2 and arr.size > int(arr[0]):
            # packed format: [header_width, obj_width, obj...]
            hw = int(arr[0])
            ow = int(arr[1]) if arr.size > 1 else 5
            body = arr[hw:]
            if ow >= 5 and body.size >= ow:
                objs = body[:(body.size // ow) * ow].reshape(-1, ow)[:, :5]
            else:
                objs = body.reshape(-1, 5) if body.size % 5 == 0 else \
                    np.zeros((0, 5), np.float32)
        elif arr.size % 5 == 0 and arr.size:
            objs = arr.reshape(-1, 5)
        else:
            objs = np.zeros((0, 5), np.float32)
        out = np.full((self._max_objects, 5), self._label_pad_value,
                      dtype=np.float32)
        n = min(len(objs), self._max_objects)
        out[:n] = objs[:n]
        return out

    def next(self):
        batch_data, batch_label = [], []
        try:
            while len(batch_data) < self.batch_size:
                label_raw, img = self.next_sample()
                label = self._parse_label(label_raw)
                for aug in self.detauglist:
                    img, label = aug(img, label)
                batch_data.append(nd.transpose(img.astype(self._dtype),
                                               axes=(2, 0, 1)))
                batch_label.append(label)
        except StopIteration:
            if not batch_data:
                raise
        pad = self.batch_size - len(batch_data)
        for _ in range(pad):
            batch_data.append(batch_data[-1])
            batch_label.append(batch_label[-1])
        return io_mod.DataBatch(
            data=[host_array(nd.stack(*batch_data)._data)],
            label=[host_array(np.stack(batch_label))], pad=pad)
