"""``mx.nd.random``, ``mx.nd.contrib`` and ``mx.nd.image``: façades over
the same op table with the prefix stripped (``_random_uniform`` ->
``nd.random.uniform``, ``_contrib_flash_attention`` ->
``nd.contrib.flash_attention``, ``_image_to_tensor`` ->
``nd.image.to_tensor``), as in ``mxnet_tpu/ndarray/op_namespaces.py``.
``linalg`` comes with its ops (ROADMAP.md).
"""
from __future__ import annotations

import types

from .. import random as _random
from ..ops import registry as _reg
from .register import make_op_func


def _facade(name, prefixes, extra=()):
    mod = types.ModuleType(f"mxnet_tpu_torch.ndarray.{name}")
    # earlier prefixes win (_random_ over _sample_), whatever the order in
    # which the ops were registered
    for p in prefixes:
        for opname in _reg.all_names():
            short = opname[len(p):]
            if opname.startswith(p) and short and not hasattr(mod, short):
                setattr(mod, short, make_op_func(_reg.get(opname)))
    for opname in extra:
        setattr(mod, opname, make_op_func(_reg.require(opname)))
    return mod


random = _facade("random", ("_random_", "_sample_"), extra=("shuffle",))
random.multinomial = make_op_func(_reg.require("_sample_multinomial"))
random.seed = _random.seed

contrib = _facade("contrib", ("_contrib_",))

image = _facade("image", ("_image_",))
