"""SGD and Adam update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py:36-60`` and ``:85-96``), as plain in-place
functions on tensors.

Each step of the arithmetic is one torch operation in the JAX package's
order (rescale, clip, add ``wd * weight``, then the optimizer's own steps),
so that the grouped ``torch._foreach_*`` update of
``optimizer/aggregate.py``, which repeats the same operations, gives the
same numbers.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    """``clip(rescale_grad * grad) + wd * weight``, a new tensor; clipping
    is on for a positive ``clip_gradient`` only."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g.clamp_(-clip_gradient, clip_gradient)
    return g.add_(weight * wd)


@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """``weight -= lr * g`` in place."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    weight.sub_(g.mul_(lr))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """``mom = momentum * mom - lr * g; weight += mom`` in place (MXNet
    folds ``lr`` into the momentum buffer)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_(g.mul_(lr))
    weight.add_(mom)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """``mean = beta1 * mean + (1 - beta1) * g``, ``var = beta2 * var +
    (1 - beta2) * g^2``, ``weight -= lr * mean / (sqrt(var) + epsilon)``,
    all in place; ``lr`` already carries Adam's bias correction (the
    optimizer folds it in)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mean.mul_(beta1).add_(g * (1 - beta1))
    var.mul_(beta2).add_((g * g).mul_(1 - beta2))
    weight.sub_(mean.mul(lr).div_(var.sqrt().add_(epsilon)))
