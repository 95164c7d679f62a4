"""Image IO and the augmenter pipeline (reference
``python/mxnet/image/image.py``; the port's copy of
``mxnet_tpu/image/image.py``).

Decoding and augmentation are host work: cv2 decodes, and the images are
CPU NDArrays (HWC uint8), as MXNet's are, whatever the current context;
the random augmenters draw from Python's ``random`` and numpy's global
generator, as in the JAX package, so the same seeds give the same images.
``ImageIter`` gives host batches (``io.host_array``: pinned when a GPU is
visible).
"""
from __future__ import annotations

import os
import random

import numpy as np

from .. import io as io_mod
from .. import ndarray as nd
from .. import recordio
from ..context import cpu
from ..io.io import host_array
from ..ndarray import NDArray


def _host(a, dtype=None):
    """A CPU NDArray of the numpy array ``a``."""
    return nd.array(a, ctx=cpu(), dtype=dtype)


def imread(filename, flag=1, to_rgb=True):
    """Read an image file → HWC uint8 NDArray (reference ``image.py:81``)."""
    import cv2
    img = cv2.imread(filename, cv2.IMREAD_COLOR if flag else
                     cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError(f"cannot read image {filename}")
    if to_rgb and img.ndim == 3:
        img = img[:, :, ::-1]
    return _host(np.ascontiguousarray(img), dtype="uint8")


def imdecode(buf, flag=1, to_rgb=True):
    """Decode an encoded image buffer (reference ``image.py:147``)."""
    import cv2
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().astype(np.uint8)
    arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) \
        else np.asarray(buf, dtype=np.uint8)
    img = cv2.imdecode(arr, int(flag) if flag in (0, 1, -1) else 1)
    if img is None:
        raise ValueError("cannot decode image")
    if to_rgb and img.ndim == 3:
        img = img[:, :, ::-1]
    return _host(np.ascontiguousarray(img), dtype="uint8")


def imresize(src, w, h, interp=1):
    """Resize to (w, h) (reference ``image.py:201``)."""
    import cv2
    arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    out = cv2.resize(arr, (int(w), int(h)),
                     interpolation=cv2.INTER_LINEAR if interp else
                     cv2.INTER_NEAREST)
    return nd.array(out, ctx=src.context if isinstance(src, NDArray)
                    else cpu(), dtype=str(arr.dtype))


def scale_down(src_size, size):
    """Scale crop size down to fit src (reference ``image.py:254``)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize shorter edge to ``size`` (reference ``image.py:351``)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop a fixed region then optionally resize (reference
    ``image.py:393``)."""
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, *size, interp=interp)
    return out


def random_crop(src, size, interp=2):
    """Random crop of ``size``, padding via scale_down (reference
    ``image.py:421``)."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop (reference ``image.py:461``)."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random area/aspect crop (reference ``image.py:512``)."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = random.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std (reference ``image.py:560``); ``mean`` and
    ``std`` are taken to ``src``'s context."""
    if mean is not None:
        src = src - _on(mean, src)
    if std is not None:
        src = src / _on(std, src)
    return src


def _on(v, src):
    if isinstance(v, NDArray):
        return v.as_in_context(src.context)
    return nd.array(v, ctx=src.context)


# ------------------------------------------------------------------ augmenters
class Augmenter:
    """Image augmenter base (reference ``image.py:590``)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                kwargs[k] = v.asnumpy().tolist()

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, *self.size, interp=self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return nd.flip(src, axis=1)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        gray = (src.asnumpy() * self.coef).sum() * 3.0 / src.size
        return src * alpha + gray * (1.0 - alpha)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        gray = (src.asnumpy() * self.coef).sum(axis=2, keepdims=True)
        return src * alpha + nd.array(gray * (1.0 - alpha), ctx=src.context)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]])
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]])

    def __call__(self, src):
        alpha = random.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        return nd.dot(src, nd.array(t, ctx=src.context, dtype=src.dtype))


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval)
        self.eigvec = np.asarray(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return src + nd.array(rgb, ctx=src.context, dtype=src.dtype)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference ``image.py:1090``)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = np.asarray(mean)
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = np.asarray(std)
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(io_mod.DataIter):
    """Python image iterator over .rec or .lst+images (reference
    ``image.py:1185``)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, dtype="float32",
                 last_batch_handle="pad", **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._dtype = dtype
        if path_imgrec:
            self.imgrec = recordio.MXIndexedRecordIO(
                path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx",
                path_imgrec, "r") if (path_imgidx and
                                      os.path.isfile(path_imgidx)) \
                else recordio.MXRecordIO(path_imgrec, "r")
        else:
            self.imgrec = None
        self.imglist = None
        self.path_root = path_root
        if path_imglist:
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in fin:
                    ln = line.strip().split("\t")
                    label = np.array([float(i) for i in ln[1:-1]],
                                     dtype=np.float32)
                    key = int(ln[0])
                    imglist[key] = (label, ln[-1])
                    imgkeys.append(key)
            self.imglist = imglist
            self.seq = imgkeys
        elif isinstance(imglist, list):
            result = {}
            imgkeys = []
            for i, img in enumerate(imglist):
                key = str(i)
                label = np.array(img[0], dtype=np.float32) \
                    if not isinstance(img[0], (int, float)) \
                    else np.array([img[0]], dtype=np.float32)
                result[key] = (label, img[1])
                imgkeys.append(key)
            self.imglist = result
            self.seq = imgkeys
        elif isinstance(self.imgrec, recordio.MXIndexedRecordIO):
            self.seq = list(self.imgrec.keys)
        else:
            self.seq = None
        self.shuffle = shuffle
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                         "mean", "std", "brightness", "contrast",
                         "saturation", "hue", "pca_noise", "inter_method")})
        else:
            self.auglist = aug_list
        if self.seq is not None and num_parts > 1:
            per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * per:(part_index + 1) * per]
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [io_mod.DataDesc("data", (self.batch_size,) + self.data_shape,
                                np.dtype(self._dtype))]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [io_mod.DataDesc("softmax_label", shp, np.float32)]

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """One (label, decoded image) (reference ``image.py:1344``)."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, imdecode(img)
            label, fname = self.imglist[idx]
            import cv2  # noqa
            return label, imread(os.path.join(self.path_root or "", fname))
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, imdecode(img)

    def next(self):
        batch_data = []
        batch_label = []
        try:
            while len(batch_data) < self.batch_size:
                label, data = self.next_sample()
                for aug in self.auglist:
                    data = aug(data)
                batch_data.append(nd.transpose(data.astype(self._dtype),
                                               axes=(2, 0, 1)))
                batch_label.append(np.ravel(np.asarray(label))[
                    :self.label_width] if self.label_width > 1
                    else float(np.ravel(np.asarray(label))[0]))
        except StopIteration:
            if not batch_data:
                raise
        pad = self.batch_size - len(batch_data)
        for _ in range(pad):
            batch_data.append(batch_data[-1])
            batch_label.append(batch_label[-1])
        data = host_array(nd.stack(*batch_data)._data)
        label = host_array(np.asarray(batch_label, dtype=np.float32))
        return io_mod.DataBatch(data=[data], label=[label], pad=pad)
