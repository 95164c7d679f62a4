"""Contrib: ``mx.contrib.amp``, automatic mixed precision (counterpart of
``mxnet_tpu/contrib/``; the other contrib surfaces are not ported)."""
from . import amp  # noqa: F401
