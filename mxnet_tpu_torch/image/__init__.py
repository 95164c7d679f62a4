"""``mx.image`` (reference ``python/mxnet/image/``): decoding, the
augmenters and ``ImageIter`` (``image.py``), and the device prologue of
``ImageRecordIter(device_augment=True)`` (``device_augment.py``), and the
detection input path (``detection.py``: ``ImageDetIter`` and the
augmenters that move boxes with their image)."""
from .image import (  # noqa: F401
    imread, imdecode, imresize, scale_down, resize_short, fixed_crop,
    center_crop, random_crop, random_size_crop, color_normalize,
    Augmenter, SequentialAug, RandomOrderAug, ResizeAug, ForceResizeAug,
    CastAug, RandomCropAug, CenterCropAug, RandomSizedCropAug,
    HorizontalFlipAug, BrightnessJitterAug, ContrastJitterAug,
    SaturationJitterAug, HueJitterAug, ColorJitterAug, LightingAug,
    ColorNormalizeAug, CreateAugmenter, ImageIter,
)
from .detection import (  # noqa: F401
    DetAugmenter, DetHorizontalFlipAug, DetRandomCropAug, DetBorrowAug,
    CreateDetAugmenter, ImageDetIter,
)
from .device_augment import DeviceAugmenter  # noqa: F401
