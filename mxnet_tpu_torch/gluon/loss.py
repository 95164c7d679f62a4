"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``): ``L2Loss``,
``L1Loss``, ``SigmoidBinaryCrossEntropyLoss``, ``SoftmaxCrossEntropyLoss``,
``KLDivLoss``, ``CTCLoss``, ``HuberLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``,
``PoissonNLLLoss`` and ``CosineEmbeddingLoss``.

Each returns one loss per sample: the mean over every axis but
``batch_axis`` (``TripletLoss`` a sum, ``CTCLoss`` and
``CosineEmbeddingLoss`` none, ``PoissonNLLLoss`` the mean of all, as
there).  ``autograd.backward`` of that vector (ones as head
gradients) and ``Trainer.step(batch_size)`` (gradients scaled by
``1 / batch_size``) give the batch mean's update, as in MXNet.  Under AMP
the mean, the ``log_softmax`` and the dense label's ``sum`` take float32,
as the JAX package's ``F.mean``, ``F.log_softmax`` and ``F.sum`` do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.nn import ctc_loss
from ..ops.registry import amp_inputs
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


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


def _softrelu_neg_abs(x):
    """``log(1 + exp(-|x|))``, the stable tail of the logistic losses."""
    return F.softplus(-torch.abs(x))


def _log(x):
    x, = amp_inputs("log", x)
    return torch.log(x)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy (``mxnet_tpu/gluon/loss.py:112``): of logits,
    in the stable form ``relu(x) - x z + log(1 + exp(-|x|))``, or with
    ``from_sigmoid`` of probabilities (``eps`` 1e-12 inside the logs);
    ``pos_weight`` scales the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + _softrelu_neg_abs(pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu_neg_abs(pred) + F.relu(-pred))
        else:
            eps = 1e-12
            pos = _log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + _log(1. - pred + eps) * (1. - label))
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)`` (``mxnet_tpu/gluon/loss.py:
    174``); ``pred`` is log-probabilities unless ``from_logits=False``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred, = amp_inputs("log_softmax", pred)
            pred = torch.log_softmax(pred, self._axis)
        loss = label * (_log(label + 1e-12) - pred)
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class CTCLoss(Loss):
    """Connectionist temporal classification (``mxnet_tpu/gluon/loss.py:
    189``): the ``CTCLoss`` op with the blank label last, ``pred`` in
    ``"NTC"`` or ``"TNC"`` and ``label`` in ``"NT"`` or ``"TN"``; labels
    are padded with -1 unless ``label_lengths`` is given.  One loss per
    sequence, not averaged."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"Only 'NTC' and 'TNC' layouts for pred are "
                             f"supported. Got: {layout}")
        if label_layout not in ("NT", "TN"):
            raise ValueError(f"Only 'NT' and 'TN' layouts for label are "
                             f"supported. Got: {label_layout}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"))

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        pred, = amp_inputs("CTCLoss", pred)
        loss = ctc_loss(pred, label, pred_lengths, label_lengths,
                        blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smoothed L1 (``mxnet_tpu/gluon/loss.py:223``): ``|d| - rho / 2``
    past ``rho``, ``d^2 / (2 rho)`` inside."""

    def __init__(self, rho=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class HingeLoss(Loss):
    """``max(0, margin - pred * label)`` (``mxnet_tpu/gluon/loss.py:
    240``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * label.reshape(pred.shape))
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class SquaredHingeLoss(HingeLoss):
    """``max(0, margin - pred * label)^2`` (``mxnet_tpu/gluon/loss.py:
    254``)."""

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(F.relu(self._margin
                                   - pred * label.reshape(pred.shape)))
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` (``mxnet_tpu/gluon/loss.py:268``)
    for ``"signed"`` labels (-1, 1), which become 0 and 1 first, or
    ``"binary"`` ones; computed in the stable form of the BCE."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise ValueError(f"label_format can only be signed or binary, "
                             f"recieved {label_format}.")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + _softrelu_neg_abs(pred)
        return self._batch_mean(
            _apply_weighting(loss, self._weight, sample_weight))


class TripletLoss(Loss):
    """``max(|pos - pred|^2 - |neg - pred|^2 + margin, 0)``, squares summed
    over every axis but ``batch_axis`` (``mxnet_tpu/gluon/loss.py:
    291``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative):
        d = torch.square(positive.reshape(pred.shape) - pred) \
            - torch.square(negative.reshape(pred.shape) - pred)
        d, = amp_inputs("sum", d)
        axes = [a for a in range(d.dim()) if a != self._batch_axis % d.dim()]
        loss = F.relu((d.sum(dim=axes) if axes else d) + self._margin)
        return _apply_weighting(loss, self._weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood (``mxnet_tpu/gluon/loss.py:307``):
    ``exp(pred) - target * pred`` of log-rates (``from_logits``), else
    ``pred - target * log(pred + epsilon)``; ``compute_full`` adds
    Stirling's term where ``target > 1``.  The mean over all elements."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            e, = amp_inputs("exp", pred)
            loss = torch.exp(e) - target * pred
        else:
            loss = pred - target * _log(pred + epsilon)
        if self._compute_full:
            stirling = target * _log(target) - target \
                + 0.5 * _log(2 * target * math.pi)
            loss = loss + stirling * (target > 1)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        loss, = amp_inputs("mean", loss)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, ``max(0, cos - margin)``
    for label -1, one per sample as an ``(N, 1)`` column
    (``mxnet_tpu/gluon/loss.py:320``); the norms' product is floored at
    1e-12."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        label = label.reshape(-1, 1)
        x, y = amp_inputs("norm", input1, input2)
        norms = (torch.linalg.vector_norm(x, dim=-1)
                 * torch.linalg.vector_norm(y, dim=-1)).reshape(-1, 1)
        dot, = amp_inputs("sum", input1 * input2)
        cos = dot.sum(dim=-1).reshape(-1, 1) / torch.clamp_min(norms, 1e-12)
        loss = (1 - cos) * (label == 1) \
            + F.relu(cos - self._margin) * (label == -1)
        return _apply_weighting(loss, self._weight, sample_weight)
