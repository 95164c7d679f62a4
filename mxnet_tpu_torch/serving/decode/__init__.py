"""``mxnet_tpu_torch.serving.decode``: autoregressive decode with continuous
batching and a paged, slot-generation KV cache (counterpart of
``mxnet_tpu/serving/decode/``).

- :class:`CausalLM` (``model.py``): decoder-only transformer whose prefill
  and per-token step share one layer function, row-stable on the card
  through the port's ``rowdot`` and paged-attention kernels and the flash
  kernel, so a request's tokens are bitwise independent of its batch.
- :class:`PagedKVCache` (``kv_cache.py``): page pools on the device with a
  trash page for padding, generation-stamped slots, refcounted
  shared-prefix pages with copy-on-write, and int8 or fp8 pools.
- :class:`DecodeRuntime` (``runtime.py``): the (batch x seqlen) prefill
  grid, one step shape per batch bucket and one verify shape per (batch,
  k) bucket, all run at load; ``decode.compile_miss`` counts any other.
- :class:`DecodeScheduler` / :class:`DecodeSession` (``scheduler.py``):
  continuous batching with joins at step boundaries, immediate eviction,
  backpressure, deadlines, a circuit breaker and shedding on KV
  exhaustion.
- :class:`NgramDrafter` / :class:`ModelDrafter` (``speculate.py``):
  speculative decoding whose emitted stream is bitwise the plain one.

Minimal use::

    import mxnet_tpu_torch as mx

    net = mx.serving.decode.get_decode_model("decode_small")
    net.initialize()                       # on the GPU
    sess = mx.serving.decode.DecodeSession(net, page_size=16)
    fut = sess.submit([5, 9, 2], max_new_tokens=32, temperature=0.8,
                      seed=7, deadline_ms=5000)
    print(fut.result().token_ids)
    sess.close()
"""
from .kv_cache import (  # noqa: F401
    KVCacheExhausted,
    KVSlot,
    PagedKVCache,
    pages_needed,
)
from .model import (  # noqa: F401
    CausalLM,
    get_decode_model,
    kv_dequantize,
    kv_dequantize_fp8,
    kv_quantize_rows,
    kv_quantize_rows_fp8,
    rowdot,
)
from .runtime import DecodeRuntime, seq_bucket_ladder  # noqa: F401
from .scheduler import (  # noqa: F401
    DecodeScheduler,
    DecodeSession,
    GenerationResult,
    TokenStream,
)
from .speculate import (  # noqa: F401
    Drafter,
    ModelDrafter,
    NgramDrafter,
    SpecState,
)

__all__ = ["CausalLM", "get_decode_model", "rowdot",
           "kv_quantize_rows", "kv_dequantize",
           "kv_quantize_rows_fp8", "kv_dequantize_fp8",
           "PagedKVCache", "KVSlot", "KVCacheExhausted", "pages_needed",
           "DecodeRuntime", "seq_bucket_ladder",
           "DecodeScheduler", "DecodeSession", "GenerationResult",
           "TokenStream",
           "Drafter", "NgramDrafter", "ModelDrafter", "SpecState"]
