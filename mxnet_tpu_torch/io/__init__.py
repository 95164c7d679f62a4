"""``mx.io``: the data iterators of the Module path (``io.py``)."""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter,  # noqa: F401
                 ResizeIter)
