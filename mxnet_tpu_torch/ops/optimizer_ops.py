"""SGD and Adam update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py:36-96``), their multi-precision variants
and the gradient finiteness scans ``all_finite``/``multi_all_finite``
(``:235-264``), as plain in-place functions on tensors.

Each step of the arithmetic is one torch operation in the JAX package's
order (rescale, clip, add ``wd * weight``, then the optimizer's own steps),
so that the grouped ``torch._foreach_*`` update of
``optimizer/aggregate.py``, which repeats the same operations, gives the
same numbers.
"""
from __future__ import annotations

import torch

from ..base import parse_float
from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "all_finite",
           "multi_all_finite"]


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
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=None):
    """Multi-precision SGD: :func:`sgd_update` on the fp32 master copy
    ``weight32`` with the gradient in fp32, then ``weight`` (fp16) takes
    the master's value, all in place."""
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    weight32.sub_(g.mul_(lr))
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=None):
    """Multi-precision :func:`sgd_mom_update`: the fp32 momentum and master
    copy take the update, ``weight`` (fp16) the master's value."""
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_(g.mul_(lr))
    weight32.add_(mom)
    weight.copy_(weight32)


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


def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    """1.0 (float32, shape (1,)) when every element of every array is
    finite, else 0.0 (reference ``src/operator/contrib/all_finite.cc``):
    AMP's gradient-overflow scan.  One multi-tensor max-norm over the
    arrays (NaN and inf propagate into it) and one reduction of the norms,
    so the answer costs a single read on the host, not one per array."""
    if not arrays:
        return torch.ones(1)
    norms = torch._foreach_norm(list(arrays), ord=float("inf"))
    ok = torch.isfinite(torch.stack([n.float() for n in norms])).all()
    return ok.float().reshape(1)


all_finite = multi_all_finite


# --------------------------------------------------------------- op table
# ``mx.nd.sgd_update`` & co. under the JAX package's names and attributes
# (``mxnet_tpu/ops/optimizer_ops.py``).  Each writes the weight and its
# states in place with the functions above, which is the write-back the
# JAX package's frontend does by rebinding, and returns the weight.
INPLACE_UPDATES = ("sgd_update", "sgd_mom_update", "mp_sgd_update",
                   "mp_sgd_mom_update", "adam_update")


def _common(wd, rescale_grad, clip_gradient):
    return dict(wd=parse_float(wd, 0.0),
                rescale_grad=parse_float(rescale_grad, 1.0),
                clip_gradient=parse_float(clip_gradient))


@register("sgd_update")
def _sgd_update_op(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    sgd_update(weight, grad, parse_float(lr),
               **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("sgd_mom_update")
def _sgd_mom_update_op(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    sgd_mom_update(weight, grad, mom, parse_float(lr),
                   parse_float(momentum, 0.0),
                   **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("mp_sgd_update")
def _mp_sgd_update_op(weight, grad, weight32, lr=None, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    mp_sgd_update(weight, grad, weight32, parse_float(lr),
                  **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("mp_sgd_mom_update")
def _mp_sgd_mom_update_op(weight, grad, mom, weight32, lr=None, momentum=0.0,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                          lazy_update=True):
    mp_sgd_mom_update(weight, grad, mom, weight32, parse_float(lr),
                      parse_float(momentum, 0.0),
                      **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("adam_update")
def _adam_update_op(weight, grad, mean, var, lr=None, beta1=0.9, beta2=0.999,
                    epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, lazy_update=True):
    adam_update(weight, grad, mean, var, parse_float(lr),
                parse_float(beta1, 0.9), parse_float(beta2, 0.999),
                parse_float(epsilon, 1e-8),
                **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("all_finite", wrap_list=True)
def _all_finite_op(*arrays, init_output=True):
    return multi_all_finite(*arrays)


@register("multi_all_finite", wrap_list=True)
def _multi_all_finite_op(*arrays, num_arrays=1, init_output=True):
    return multi_all_finite(*arrays)
