"""Gluon surface of the port."""
from . import loss, model_zoo, nn  # noqa: F401
from .block import HybridBlock, io_signature  # noqa: F401
from .parameter import Parameter  # noqa: F401
from .trainer import Trainer  # noqa: F401
