"""Gluon layers of the port."""
from .activations import GELU, Activation  # noqa: F401
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding,  # noqa: F401
                           Flatten, HybridSequential, LayerNorm)
from .conv_layers import (AvgPool2D, Conv1D, Conv2D, Conv3D,  # noqa: F401
                          GlobalAvgPool2D, MaxPool2D)
