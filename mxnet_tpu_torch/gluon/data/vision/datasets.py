"""Vision datasets (reference ``python/mxnet/gluon/data/vision/datasets.py``;
the port's copy of ``mxnet_tpu/gluon/data/vision/datasets.py``).

Nothing is downloaded: datasets load from ``root`` when the files are
there and raise, naming the expected layout, otherwise.  Images and labels
are CPU NDArrays (HWC uint8), as in MXNet, whatever the current context.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from .... import ndarray as nd
from ....context import cpu
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    """Base for root-dir datasets (reference ``datasets.py:45``)."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    magic = struct.unpack(">I", raw[:4])[0]
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
    return np.frombuffer(raw[4 + 4 * ndim:], dtype=np.uint8).reshape(dims)


class MNIST(_DownloadedDataset):
    """MNIST (yann.lecun.com/exdb/mnist). Expects the idx(.gz) files under
    ``root``."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _find(self, stem):
        for cand in (stem, stem + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(
            f"{stem}[.gz] not found under {self._root}; the port downloads "
            "nothing — place the MNIST idx files there manually.")

    def _get_data(self):
        imgs, labs = self._train_files if self._train else self._test_files
        data = _read_idx(self._find(imgs))
        label = _read_idx(self._find(labs))
        self._data = nd.array(data.reshape(data.shape + (1,)), ctx=cpu(),
                              dtype="uint8")
        self._label = label.astype(np.int32)


class FashionMNIST(MNIST):
    """FashionMNIST — same idx layout as MNIST."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 python pickles (``cifar-10-batches-py/``) under ``root``."""

    _train_batches = ["data_batch_%d" % i for i in range(1, 6)]
    _test_batches = ["test_batch"]
    _subdir = "cifar-10-batches-py"
    _label_key = b"labels"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        base = self._root
        if os.path.isdir(os.path.join(base, self._subdir)):
            base = os.path.join(base, self._subdir)
        names = self._train_batches if self._train else self._test_batches
        datas, labels = [], []
        for name in names:
            path = os.path.join(base, name)
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"{path} not found; the port downloads nothing — place the CIFAR "
                    f"python batches under {self._root}.")
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            datas.append(d[b"data"].reshape(-1, 3, 32, 32))
            labels.extend(d[self._label_key])
        data = np.concatenate(datas).transpose(0, 2, 3, 1)  # NHWC uint8
        self._data = nd.array(data, ctx=cpu(), dtype="uint8")
        self._label = np.asarray(labels, dtype=np.int32)


class CIFAR100(CIFAR10):
    _train_batches = ["train"]
    _test_batches = ["test"]
    _subdir = "cifar-100-python"
    _label_key = b"fine_labels"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._label_key = b"fine_labels" if fine_label else b"coarse_labels"
        super().__init__(root, train, transform)


class ImageRecordDataset(RecordFileDataset):
    """Images in a ``.rec`` file (reference ``datasets.py:270``)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio
        record = super().__getitem__(idx)
        header, img = recordio.unpack_img(
            record, iscolor=1 if self._flag else 0)
        if img.ndim == 3:
            img = img[:, :, ::-1]  # BGR → RGB
        image = nd.array(np.ascontiguousarray(img), ctx=cpu(), dtype="uint8")
        label = header.label
        if self._transform is not None:
            return self._transform(image, label)
        return image, label


class ImageFolderDataset(Dataset):
    """``root/category/image.jpg`` layout (reference ``datasets.py:300``)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        import cv2
        img = cv2.imread(self.items[idx][0],
                         cv2.IMREAD_COLOR if self._flag else
                         cv2.IMREAD_GRAYSCALE)
        if img.ndim == 3:
            img = img[:, :, ::-1]
        img = nd.array(np.ascontiguousarray(img), ctx=cpu(), dtype="uint8")
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
