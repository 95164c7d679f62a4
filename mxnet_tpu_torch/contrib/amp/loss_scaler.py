"""Dynamic loss scaler (counterpart of
``mxnet_tpu/contrib/amp/loss_scaler.py``).

With bfloat16 (fp32's exponent range) overflow is rare, so the scale
usually sits at its initial value; the fp16 dynamics are kept for scripts
that tune it: halve on overflow, double after ``scale_window`` clean steps.
``update_scale`` records the ``amp.overflow`` counter and the
``amp.loss_scale`` gauge on the telemetry bus when it is enabled.
"""
from __future__ import annotations

import logging

from ...ops.optimizer_ops import multi_all_finite
from ...telemetry import bus as _tel


def grads_of(params):
    """The gradient buffers of ``params`` that a backward wrote: those of
    Parameters with ``grad_req`` other than ``'null'``."""
    return [p._data.grad for p in params
            if p.grad_req != "null" and p._data is not None
            and p._data.grad is not None]


class LossScaler:
    def __init__(self, init_scale=2.**16, scale_factor=2., scale_window=2000,
                 tolerance=0.05):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient of ``params`` (those with a gradient
        buffer and ``grad_req`` other than ``'null'``) holds an inf or a
        NaN: the JAX package's per-parameter answer, from one device
        reduction over all of them (``multi_all_finite``) and one host
        read."""
        grads = grads_of(params)
        if not grads:
            return False
        return not bool(multi_all_finite(*grads).item())

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1)
            self._unskipped = 0
            logging.info("AMP: decreasing loss scale to %f", self.loss_scale)
            if _tel.enabled:
                _tel.count("amp.overflow")
                _tel.instant("amp.overflow", scale=self.loss_scale)
                _tel.gauge("amp.loss_scale", self.loss_scale)
        else:
            self._unskipped += 1
        if self._unskipped == self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0
            _tel.gauge("amp.loss_scale", self.loss_scale)
