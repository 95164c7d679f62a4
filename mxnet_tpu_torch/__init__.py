"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA Hopper.

Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
is a hand-written CUDA kernel here (``csrc/``, built with ``nvcc`` on first
use), and ``mx.rtc`` compiles user CUDA source with NVRTC.  Training runs
through ``mx.autograd`` (on ``torch.autograd``), ``gluon.loss``,
``gluon.Trainer``, ``mx.optimizer`` (SGD, Adam) and ``mx.lr_scheduler``.
The package imports neither JAX nor ``mxnet_tpu``.  Entry points run on
the GPU unless the caller passes ``device="cpu"``.
"""
from . import autograd, context, convert, gluon, initializer  # noqa: F401
from . import lr_scheduler, models, ndarray, ops, optimizer  # noqa: F401
from . import rtc, serving  # noqa: F401
from . import telemetry  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .context import Context, cpu, gpu  # noqa: F401
