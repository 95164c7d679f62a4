"""Data iterators (the port's counterpart of ``mxnet_tpu/io/io.py``, the
part the Module path needs): ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter`` and ``ResizeIter``.

``NDArrayIter`` keeps its data as host numpy arrays and makes each batch an
NDArray on the current context (the GPU unless the caller runs under
``with mx.cpu():``), one host-to-device copy a batch; ``shuffle`` draws from
numpy's global generator, as the JAX package does.  ``PrefetchingIter``,
``DevicePrefetchIter`` and the record/image iterators are ROADMAP.md queue 1
item 5.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name/shape/type descriptor (reference ``io.py:68``)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        """Axis of the batch dimension in ``layout`` (reference ``io.py:118``)."""
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference ``io.py:146``)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Iterator base (reference ``io.py:212``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch (reference
    ``io.py:308``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Normalize data into an OrderedDict of name→np.ndarray (reference
    ``io.py:574 _init_data``)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict(
                [("_%d_%s" % (i, default_name), d) for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = OrderedDict()
    for k, v in data.items():
        if isinstance(v, NDArray):
            out[k] = v.asnumpy()
        else:
            out[k] = np.asarray(v)
    return list(out.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference ``io.py:623``), with
    ``shuffle`` and MXNet 1.5's ``last_batch_handle``: ``'pad'`` fills the
    last batch from the start of the data (``pad`` counts the filler
    rows), ``'discard'`` drops an incomplete last batch, ``'roll_over'``
    keeps it for the next epoch, whose first batch is those rows followed
    by the first of the data (``pad`` counts the rows carried over).

    The JAX package's ``roll_over`` returns the incomplete batch padded
    and starts the next epoch with a short batch; the port follows the
    reference (ROADMAP.md, reference-side defects)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError(f"last_batch_handle must be 'pad', 'discard' "
                             f"or 'roll_over', got {last_batch_handle!r}")
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._cache = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        """Start over, dropping a carried-over batch."""
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        if self.last_batch_handle == "roll_over" and \
                self.num_data - self.batch_size < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def _shuffle_data(self):
        perm = np.random.permutation(self.num_data)
        self.data = [(k, v[perm]) for k, v in self.data]
        self.label = [(k, v[perm]) for k, v in self.label]

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        rows = self._rows()
        if self.cursor < 0:
            self._cache = None           # the carried-over rows are used
        if len(rows[0]) != self.batch_size:
            # an incomplete last batch: dropped, or kept for the next epoch
            if self.last_batch_handle == "roll_over":
                self._cache = rows
            raise StopIteration
        nd_data = [nd.array(r) for r in rows[:len(self.data)]]
        nd_label = [nd.array(r) for r in rows[len(self.data):]]
        return DataBatch(data=nd_data, label=nd_label, pad=self.getpad(),
                         index=None)

    def _rows(self):
        """The numpy rows of the batch at the cursor, data then labels."""
        sources = [v for _, v in self.data] + [v for _, v in self.label]
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            if self._cache is None:
                raise RuntimeError("roll_over: no batch carried over from "
                                   "the last epoch")
            return [np.concatenate([c, v[:self.cursor + self.batch_size]])
                    for c, v in zip(self._cache, sources)]
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return [np.concatenate([v[self.cursor:],
                                    v[:end - self.num_data]])
                    for v in sources]
        return [v[self.cursor:min(end, self.num_data)] for v in sources]

    def getdata(self):
        return [nd.array(r) for r in self._rows()[:len(self.data)]]

    def getlabel(self):
        return [nd.array(r) for r in self._rows()[len(self.data):]]

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            return -self.cursor
        return 0
