"""``mx.nd``: the NDArray, its creation functions and one function per name
in the op table (counterpart of ``mxnet_tpu/ndarray/__init__.py``), plus
the ``random`` and ``contrib`` sub-namespaces and MXNet's ``.params``
files (``save``/``load``/``load_frombuffer`` on NDArrays).
"""
import sys as _sys

from .ndarray import (  # noqa: F401
    NDArray, add, arange, array, concatenate, divide, empty, equal, eye,
    full, greater, greater_equal, invoke, invoke_fn, invoke_op, lesser,
    lesser_equal, load, load_frombuffer, logical_and, logical_or,
    logical_xor, maximum, minimum, modulo, moveaxis, multiply, not_equal,
    ones, ones_like, power, save, stack, subtract, transpose, waitall,
    zeros, zeros_like,
)
from . import register as _register

_OPS = _register.populate(_sys.modules[__name__])

from . import op_namespaces as _ns  # noqa: E402

random = _ns.random
contrib = _ns.contrib
