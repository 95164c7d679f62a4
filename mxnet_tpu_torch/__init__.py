"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA Hopper.

Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
is a hand-written CUDA kernel here (``csrc/``, built with ``nvcc`` on first
use), and ``mx.rtc`` compiles user CUDA source with NVRTC.  ``mx.nd`` is
MXNet's NDArray on torch tensors, with one function per name in the op
table (``ops/``).  Training runs through ``mx.autograd`` (on
``torch.autograd``), ``gluon.loss``, ``gluon.Trainer``, ``mx.optimizer``
(SGD, Adam) and ``mx.lr_scheduler``.  The symbolic path is ``mx.sym``
(graphs over the same op table), the ``Executor``, ``mx.kv`` (the local
store), ``mx.io``, ``mx.metric``, ``mx.init``, ``mx.callback``,
``mx.model`` and ``mx.mod.Module``.  Mixed precision is
``mx.contrib.amp`` (bf16 on the tensor cores, its loss scaler) with
multi-precision SGD for fp16 weights.  The data path is ``mx.recordio``,
``mx.io``'s record iterators (threads, worker processes, a device
augmentation prologue, staging on a side stream), ``mx.image`` and
``gluon.data``; its batches are host (CPU) NDArrays, pinned when a GPU is
visible.  Generative serving is ``mx.serving.decode``: a causal LM decoded
with continuous batching over a paged KV cache, on the port's row-stable
contraction and paged-attention kernels.  The package imports neither JAX nor
``mxnet_tpu``.  Entry points run on the GPU unless the caller asks for the
CPU (``device="cpu"``, ``ctx=mx.cpu()`` or ``with mx.cpu():``).
"""
from . import autograd, base, context, convert, gluon, initializer  # noqa
from . import lr_scheduler, models, ndarray, ops, optimizer  # noqa: F401
from . import name, random, rtc, serving  # noqa: F401
from . import telemetry  # noqa: F401
from . import callback, executor, io, kvstore, metric, model  # noqa: F401
from . import image, recordio  # noqa: F401
from . import module, symbol  # noqa: F401
from . import contrib  # noqa: F401
from . import initializer as init  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import module as mod  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import symbol as sym  # noqa: F401
from .context import (Context, cpu, current_context, gpu,  # noqa: F401
                      num_gpus)

# mx.random.uniform & co. are mx.nd.random's samplers, as in MXNet
for _name in dir(nd.random):
    if not _name.startswith("_") and not hasattr(random, _name):
        setattr(random, _name, getattr(nd.random, _name))
del _name
