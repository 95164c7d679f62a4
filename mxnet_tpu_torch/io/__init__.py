"""``mx.io``: data iterators (``io.py``), the record and dataset iterators
(``iterators.py``) and the multi-process decode pipeline behind
``ImageRecordIter`` (``pipeline.py``, ``shm_ring.py``)."""
from .io import (DataBatch, DataDesc, DataIter,  # noqa: F401
                 DevicePrefetchIter, NDArrayIter, PrefetchingIter,
                 ResizeIter)
from .iterators import (CSVIter, ImageDetRecordIter,  # noqa: F401
                        ImageRecordIter, LibSVMIter, MNISTIter)
from .pipeline import (BatchDecodeError, DecodeSpec,  # noqa: F401
                       ProcessDecodePool, RecordShardSampler)
from .shm_ring import ShmRing  # noqa: F401
