"""``mx.mod``: MXNet's Module API, ``BaseModule`` and ``Module`` (the
port's counterpart of ``mxnet_tpu/module/``).  ``BucketingModule``,
``SequentialModule`` and ``PythonModule`` are ROADMAP.md queue 1 item 7.
"""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
