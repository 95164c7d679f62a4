"""Gluon surface of the port."""
from . import model_zoo, nn  # noqa: F401
from .block import HybridBlock, io_signature  # noqa: F401
