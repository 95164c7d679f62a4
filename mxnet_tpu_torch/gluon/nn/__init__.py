"""Gluon layers of the port."""
from .activations import (ELU, GELU, SELU, Activation, LeakyReLU,  # noqa
                          PReLU, Swish)
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding,  # noqa: F401
                           Flatten, HybridLambda, HybridSequential,
                           InstanceNorm, Lambda, LayerNorm, Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D,  # noqa: F401
                          Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                          Conv3D, Conv3DTranspose, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalAvgPool3D, GlobalMaxPool1D,
                          GlobalMaxPool2D, GlobalMaxPool3D, MaxPool1D,
                          MaxPool2D, MaxPool3D, ReflectionPad2D)
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
