"""Serving stack of the port: the bucketed runtime and dynamic batcher
(one-shot serving) and :mod:`.decode` (generative serving with continuous
batching over a paged KV cache).  The JAX package's ``ModelRegistry``,
``aot``, ``gateway`` and ``fleet`` are ROADMAP queue 1 item 8 and not
ported yet."""
from . import decode  # noqa: F401
from .batcher import Batcher, RequestRejected  # noqa: F401
from .runtime import ModelRuntime, default_buckets  # noqa: F401

__all__ = ["ModelRuntime", "Batcher", "RequestRejected", "default_buckets",
           "decode"]
