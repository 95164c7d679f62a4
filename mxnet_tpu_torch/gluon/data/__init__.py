"""Gluon data API (reference ``python/mxnet/gluon/data/``): datasets,
samplers, ``DataLoader`` and ``vision``."""
from .dataset import (  # noqa: F401
    Dataset, SimpleDataset, ArrayDataset, RecordFileDataset,
)
from .sampler import (  # noqa: F401
    Sampler, SequentialSampler, RandomSampler, BatchSampler,
)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
