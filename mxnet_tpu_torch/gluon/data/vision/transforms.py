"""Image transforms as Blocks (reference
``python/mxnet/gluon/data/vision/transforms.py``; the port's copy of
``mxnet_tpu/gluon/data/vision/transforms.py``), over the ``mx.nd.image``
operators (``ops/image_ops.py``).  They run on their input's device: in a
``DataLoader`` worker, on CPU NDArrays.  The random ones draw from the
device's torch generator (``mx.random.seed``), except
``RandomResizedCrop``, which draws from numpy's global generator, as in
the JAX package."""
from __future__ import annotations

import numpy as np

from .... import ndarray as nd
from ...block import Block, HybridBlock
from ...nn import Sequential, HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomLighting", "RandomColorJitter"]


class Compose(Sequential):
    """Sequentially compose transforms (reference ``transforms.py:37``);
    consecutive hybridizable ones are gathered into one hybridized
    ``HybridSequential``, as in MXNet (the port runs it eagerly)."""

    def __init__(self, transforms):
        super().__init__()
        transforms.append(None)
        hybrid = []
        for i in transforms:
            if isinstance(i, HybridBlock):
                hybrid.append(i)
                continue
            if len(hybrid) == 1:
                self.add(hybrid[0])
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                for j in hybrid:
                    hblock.add(j)
                hblock.hybridize()
                self.add(hblock)
            hybrid = []
            if i is not None:
                self.add(i)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference ``transforms.py:89``)."""

    def hybrid_forward(self, F, x):
        return F.image.to_tensor(x)


class Normalize(HybridBlock):
    """(x - mean) / std on CHW float input (reference ``transforms.py:128``)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        return F.image.normalize(x, mean=self._mean, std=self._std)


class Resize(Block):
    """Resize HWC image (reference ``transforms.py:308``)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        return nd.image.resize(x, size=self._size, keep_ratio=self._keep,
                               interp=self._interpolation)


class CenterCrop(Block):
    """Crop the center (reference ``transforms.py:268``)."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interpolation = interpolation

    def forward(self, x):
        w, h = self._size
        ih, iw = x.shape[0], x.shape[1]
        if ih < h or iw < w:
            x = nd.image.resize(x, size=(max(w, iw), max(h, ih)),
                                interp=self._interpolation)
            ih, iw = x.shape[0], x.shape[1]
        x0, y0 = (iw - w) // 2, (ih - h) // 2
        return nd.image.crop(x, x=x0, y=y0, width=w, height=h)


class RandomResizedCrop(Block):
    """Random area/aspect crop then resize (reference ``transforms.py:220``)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        ih, iw = x.shape[0], x.shape[1]
        area = ih * iw
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= iw and h <= ih:
                x0 = np.random.randint(0, iw - w + 1)
                y0 = np.random.randint(0, ih - h + 1)
                crop = nd.image.crop(x, x=x0, y=y0, width=w, height=h)
                return nd.image.resize(crop, size=self._size,
                                       interp=self._interpolation)
        return CenterCrop(self._size, self._interpolation)(x)


class RandomFlipLeftRight(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.image.random_flip_left_right(x)


class RandomFlipTopBottom(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.image.random_flip_top_bottom(x)


class RandomBrightness(HybridBlock):
    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def hybrid_forward(self, F, x):
        return F.image.random_brightness(x, *self._args)


class RandomContrast(HybridBlock):
    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def hybrid_forward(self, F, x):
        return F.image.random_contrast(x, *self._args)


class RandomSaturation(HybridBlock):
    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0, 1 - saturation), 1 + saturation)

    def hybrid_forward(self, F, x):
        return F.image.random_saturation(x, *self._args)


class RandomLighting(HybridBlock):
    """AlexNet-style PCA noise (reference ``transforms.py:460``)."""

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.image.random_lighting(x, self._alpha)


class RandomColorJitter(HybridBlock):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._args = (brightness, contrast, saturation, hue)

    def hybrid_forward(self, F, x):
        return F.image.random_color_jitter(x, *self._args)
