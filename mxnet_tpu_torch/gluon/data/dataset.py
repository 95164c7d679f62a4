"""Datasets (reference ``python/mxnet/gluon/data/dataset.py``; the port's
copy of ``mxnet_tpu/gluon/data/dataset.py``).  Plain Python: a dataset
holds whatever it is given, and ``RecordFileDataset`` reads raw records."""
from __future__ import annotations

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: ``__getitem__`` + ``__len__`` (reference
    ``dataset.py:33``)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """Return a dataset with only samples for which ``fn`` is True."""
        indices = [i for i in range(len(self)) if fn(self[i])]
        return _SampledDataset(self, indices)

    def take(self, count):
        if count is None or count >= len(self):
            return self
        return _SampledDataset(self, list(range(count)))

    def transform(self, fn, lazy=True):
        """Apply ``fn`` to each sample (reference ``dataset.py:48``)."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Apply ``fn`` to the first element only (data, not label)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """Wrap any indexable (reference ``dataset.py:90``)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _SampledDataset(Dataset):
    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    """Picklable so DataLoader workers can carry it across fork."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Zip of equal-length arrays (reference ``dataset.py:116``)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has length " \
                f"{self._length} while array[{i}] has {len(data)}."
            if isinstance(data, (list, tuple)):
                data = SimpleDataset(data)
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Raw records from a ``.rec``/``.idx`` pair (reference
    ``dataset.py:150``)."""

    def __init__(self, filename):
        from ... import recordio
        self.idx_file = filename[:filename.rindex(".")] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
