"""Operators of the port: plain PyTorch functions plus the CUDA kernels.
Importing this package fills the op table (``registry.py``) behind
``mx.nd``.

``_contrib_flash_attention`` (alias ``flash_attention``; ``mx.nd.contrib.
flash_attention``) is the counterpart of the JAX package's registration
(``mxnet_tpu/ops/__init__.py``): it maps MXNet-style string attributes onto
:func:`flash_attention`, the hand-written kernel on a CUDA tensor.  The
TPU's tile sizes and interpreter switch are taken and ignored.
``contrib.flash_attention`` is the same function for the port's own models.
"""
from types import SimpleNamespace

from . import registry  # noqa: F401
from . import elemwise, broadcast_reduce, matrix  # noqa: F401
from . import nn, random_ops, init_ops, optimizer_ops  # noqa: F401
from . import image_ops  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import flash_attention as _fa
from ..base import parse_bool
from .registry import get, list_ops, register, require  # noqa: F401


@register("_contrib_flash_attention", aliases=("flash_attention",))
def _flash_attention_op(q, k, v, causal=False, scale=None, block_q=128,
                        block_k=128, interpret=None):
    return _fa.flash_attention(
        q, k, v, parse_bool(causal),
        None if scale in (None, "None") else float(scale))


contrib = SimpleNamespace(flash_attention=_flash_attention_op)
