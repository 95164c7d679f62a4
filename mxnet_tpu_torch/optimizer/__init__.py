"""Optimizers of the port (``mx.optimizer``)."""
from .optimizer import (SGD, Adam, Optimizer, Updater,  # noqa: F401
                        create, get_updater, register)
