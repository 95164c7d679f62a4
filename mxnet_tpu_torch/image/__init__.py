"""``mx.image`` (reference ``python/mxnet/image/``): decoding, the
augmenters and ``ImageIter`` (``image.py``), and the device prologue of
``ImageRecordIter(device_augment=True)`` (``device_augment.py``).
Detection (``ImageDetIter`` and its augmenters) is ROADMAP.md item 11."""
from .image import (  # noqa: F401
    imread, imdecode, imresize, scale_down, resize_short, fixed_crop,
    center_crop, random_crop, random_size_crop, color_normalize,
    Augmenter, SequentialAug, RandomOrderAug, ResizeAug, ForceResizeAug,
    CastAug, RandomCropAug, CenterCropAug, RandomSizedCropAug,
    HorizontalFlipAug, BrightnessJitterAug, ContrastJitterAug,
    SaturationJitterAug, HueJitterAug, ColorJitterAug, LightingAug,
    ColorNormalizeAug, CreateAugmenter, ImageIter,
)
from .device_augment import DeviceAugmenter  # noqa: F401
