"""SGD update operators (counterpart of ``mxnet_tpu/ops/optimizer_ops.py:
36-60``), as plain in-place functions on tensors.

Each step of the arithmetic is one torch operation in the JAX package's
order (rescale, clip, add ``wd * weight``, scale by ``lr``), so that the
grouped ``torch._foreach_*`` update of ``optimizer/aggregate.py``, which
repeats the same operations, gives the same numbers.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update"]


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
