"""Optimizers of the port (``mx.optimizer``)."""
from .optimizer import (SGD, Optimizer, Updater, create,  # noqa: F401
                        get_updater, register)
