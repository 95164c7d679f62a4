"""Gluon surface of the port."""
from . import data, loss, model_zoo, nn, utils  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock, io_signature  # noqa
from .parameter import (Constant, DeferredInitializationError,  # noqa
                        Parameter, ParameterDict)
from .trainer import Trainer  # noqa: F401
