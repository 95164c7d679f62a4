"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``, the part the
training slice needs): ``L2Loss``, ``L1Loss`` and
``SoftmaxCrossEntropyLoss``.

Each returns one loss per sample: the mean over every axis but
``batch_axis``.  ``autograd.backward`` of that vector (ones as head
gradients) and ``Trainer.step(batch_size)`` (gradients scaled by
``1 / batch_size``) give the batch mean's update, as in MXNet.  Under AMP
the mean, the ``log_softmax`` and the dense label's ``sum`` take float32,
as the JAX package's ``F.mean``, ``F.log_softmax`` and ``F.sum`` do.
"""
from __future__ import annotations

import torch

from ..ops.registry import amp_inputs
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """``loss * sample_weight * weight`` (``mxnet_tpu/gluon/loss.py:17``);
    ``sample_weight`` broadcasts against the loss."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (float, int)):
            raise TypeError(f"weight must be a number, got {type(weight)}")
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base loss (``mxnet_tpu/gluon/loss.py:31``): a scalar ``weight`` and
    the ``batch_axis`` kept by the final mean."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, loss):
        loss, = amp_inputs("mean", loss)
        axes = [a for a in range(loss.dim())
                if a != self._batch_axis % loss.dim()]
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2`` (``mxnet_tpu/gluon/loss.py:47``)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        return self._batch_mean(
            _apply_weighting(loss, self._weight / 2, sample_weight))


class L1Loss(Loss):
    """``|pred - label|`` (``mxnet_tpu/gluon/loss.py:60``)."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy over ``axis`` (``mxnet_tpu/gluon/loss.py:109``).

    ``sparse_label``: ``label`` holds class indices (``pred``'s shape
    without ``axis``; clipped into range, as MXNet's ``pick`` does), else a
    distribution of ``pred``'s shape.  ``from_logits``: ``pred`` already
    holds log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred, = amp_inputs("log_softmax", pred)
            pred = torch.log_softmax(pred, self._axis)
        if self._sparse_label:
            idx = label.long().clamp(0, pred.shape[self._axis] - 1)
            loss = -pred.gather(self._axis, idx.unsqueeze(self._axis))
        else:
            prod, = amp_inputs("sum", pred * label.reshape(pred.shape))
            loss = -prod.sum(self._axis, keepdim=True)
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss
