"""Gluon layers of the port."""
from .activations import (ELU, GELU, SELU, Activation, LeakyReLU,  # noqa
                          PReLU, Swish)
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding,  # noqa: F401
                           Flatten, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, Sequential)
from .conv_layers import (AvgPool2D, Conv1D, Conv2D, Conv3D,  # noqa: F401
                          GlobalAvgPool2D, GlobalMaxPool1D, GlobalMaxPool2D,
                          MaxPool2D, ReflectionPad2D)
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
