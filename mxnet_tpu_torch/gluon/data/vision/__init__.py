"""Vision datasets and transforms (reference
``python/mxnet/gluon/data/vision/``)."""
from .datasets import (  # noqa: F401
    MNIST, FashionMNIST, CIFAR10, CIFAR100, ImageRecordDataset,
    ImageFolderDataset,
)
from . import transforms  # noqa: F401
