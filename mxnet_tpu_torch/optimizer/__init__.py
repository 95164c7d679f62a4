"""Optimizers of the port (``mx.optimizer``)."""
from .optimizer import (SGD, SGLD, AdaDelta, AdaGrad, Adam,  # noqa: F401
                        Adamax, DCASGD, FTML, Ftrl, LBSGD, NAG, Nadam,
                        Optimizer, RMSProp, Signum, Test, Updater, ccSGD,
                        create, get_updater, register)
