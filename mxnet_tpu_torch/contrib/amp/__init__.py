"""Automatic mixed precision (counterpart of ``mxnet_tpu/contrib/amp/``)."""
from .amp import (  # noqa: F401
    init, deinit, init_trainer, scale_loss, unscale, convert_model,
    convert_symbol, convert_hybrid_block, list_lp16_ops, list_fp32_ops,
)
from .loss_scaler import LossScaler  # noqa: F401
