"""The update operators (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``:
SGD and Adam :36-96 with their multi-precision variants, NAG, RMSProp
(plain and centered), FTRL, signSGD, Signum, FTML, AdaGrad and AdamW
:100-230) and the gradient finiteness scans ``all_finite``/
``multi_all_finite`` (:235-264), as plain in-place functions on tensors.

Each step of the arithmetic is one torch operation in the JAX package's
order (rescale, clip, add ``wd * weight``, then the optimizer's own steps),
so that the grouped update of ``optimizer/aggregate.py`` gives the same
numbers.  SGD's and Adam's functions are written per tensor and repeated
with ``torch._foreach_*`` there; the later ops are written once, over
lists (``*_multi``: ``torch._foreach_*`` calls with per-member learning
rates and weight decays), and the per-tensor op is that function on lists
of one, so the per-parameter and the grouped updates are the same
operations by construction.
"""
from __future__ import annotations

import torch

from ..base import parse_float
from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "nag_mom_update",
           "rmsprop_update", "rmspropalex_update", "ftrl_update",
           "signsgd_update", "signum_update", "ftml_update",
           "adagrad_update", "adamw_update", "all_finite",
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


# ------------------------------------------------ list-based update rules
def clipped_multi(grads, rescale_grad, clip_gradient):
    """``clip(rescale_grad * grad)`` of each gradient, new tensors."""
    g = torch._foreach_mul(grads, rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(g, -clip_gradient)
        torch._foreach_clamp_max_(g, clip_gradient)
    return g


def apply_wd_multi(weights, grads, wds, rescale_grad, clip_gradient):
    """:func:`_apply_wd` over lists, one weight decay a member."""
    g = clipped_multi(grads, rescale_grad, clip_gradient)
    torch._foreach_add_(g, torch._foreach_mul(weights, wds))
    return g


@torch.no_grad()
def nag_mom_update_multi(weights, grads, moms, lrs, wds, momentum,
                         rescale_grad=1.0, clip_gradient=None):
    """``mom = momentum * mom + g; weight -= lr * (g + momentum * mom)``."""
    g = apply_wd_multi(weights, grads, wds, rescale_grad, clip_gradient)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, g)
    step = torch._foreach_mul(moms, momentum)
    torch._foreach_add_(step, g)
    torch._foreach_mul_(step, lrs)
    torch._foreach_sub_(weights, step)


@torch.no_grad()
def rmsprop_update_multi(weights, grads, ns, lrs, wds, gamma1=0.95,
                         epsilon=1e-8, rescale_grad=1.0, clip_gradient=None,
                         clip_weights=None):
    """``n = (1 - gamma1) g^2 + gamma1 n; weight -= lr g / sqrt(n + eps)``,
    then ``weight`` clipped to ``clip_weights`` when it is positive."""
    g = apply_wd_multi(weights, grads, wds, rescale_grad, clip_gradient)
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1 - gamma1)
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_add_(ns, sq)
    den = torch._foreach_add(ns, epsilon)
    torch._foreach_sqrt_(den)
    step = torch._foreach_mul(g, lrs)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(weights, step)
    _clip_weights(weights, clip_weights)


def _clip_weights(weights, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        torch._foreach_clamp_min_(weights, -clip_weights)
        torch._foreach_clamp_max_(weights, clip_weights)


@torch.no_grad()
def rmspropalex_update_multi(weights, grads, ns, gs, deltas, lrs, wds,
                             gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                             rescale_grad=1.0, clip_gradient=None,
                             clip_weights=None):
    """Centered RMSProp (Graves): ``n = (1 - gamma1) g^2 + gamma1 n``,
    ``gbar = (1 - gamma1) g + gamma1 gbar``, ``delta = gamma2 delta - lr g
    / sqrt(n - gbar^2 + eps)``, ``weight += delta``, clipped as
    :func:`rmsprop_update_multi` (MXNet's ``clip_weights``; the JAX op
    leaves it out, its grouped rule does not)."""
    g = apply_wd_multi(weights, grads, wds, rescale_grad, clip_gradient)
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1 - gamma1)
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_add_(ns, sq)
    lin = torch._foreach_mul(g, 1 - gamma1)
    torch._foreach_mul_(gs, gamma1)
    torch._foreach_add_(gs, lin)
    den = torch._foreach_sub(ns, torch._foreach_mul(gs, gs))
    torch._foreach_add_(den, epsilon)
    torch._foreach_sqrt_(den)
    step = torch._foreach_mul(g, lrs)
    torch._foreach_div_(step, den)
    torch._foreach_mul_(deltas, gamma2)
    torch._foreach_sub_(deltas, step)
    torch._foreach_add_(weights, deltas)
    _clip_weights(weights, clip_weights)


@torch.no_grad()
def ftrl_update_multi(weights, grads, zs, ns, lrs, wds, lamda1=0.01,
                      beta=1.0, rescale_grad=1.0, clip_gradient=None):
    """FTRL-proximal: the gradient takes no weight decay (``wd`` enters
    the denominator); ``n += g^2``, ``z += g - (sqrt(n) - sqrt(n_old)) /
    lr * weight``, ``weight = -(z - sign(z) lamda1) / ((beta + sqrt(n)) /
    lr + wd)`` where ``|z| > lamda1``, else 0."""
    g = clipped_multi(grads, rescale_grad, clip_gradient)
    old = torch._foreach_sqrt(ns)
    torch._foreach_add_(ns, torch._foreach_mul(g, g))
    new = torch._foreach_sqrt(ns)
    sigma = torch._foreach_sub(new, old)
    torch._foreach_div_(sigma, lrs)
    torch._foreach_add_(zs, g)
    torch._foreach_sub_(zs, torch._foreach_mul(sigma, weights))
    den = torch._foreach_add(new, beta)
    torch._foreach_div_(den, lrs)
    torch._foreach_add_(den, wds)
    shrink = torch._foreach_sign(zs)
    torch._foreach_mul_(shrink, lamda1)
    num = torch._foreach_sub(zs, shrink)
    torch._foreach_neg_(num)
    torch._foreach_div_(num, den)
    for w, z, v in zip(weights, zs, num):
        w.copy_(torch.where(z.abs() > lamda1, v, torch.zeros_like(w)))


@torch.no_grad()
def signsgd_update_multi(weights, grads, lrs, wds, rescale_grad=1.0,
                         clip_gradient=None):
    """``weight -= lr * (sign(g) + wd * weight)``."""
    step = torch._foreach_sign(clipped_multi(grads, rescale_grad,
                                             clip_gradient))
    torch._foreach_add_(step, torch._foreach_mul(weights, wds))
    torch._foreach_mul_(step, lrs)
    torch._foreach_sub_(weights, step)


@torch.no_grad()
def signum_update_multi(weights, grads, moms, lrs, momentum=0.0,
                        rescale_grad=1.0, clip_gradient=None, wd_lh=0.0):
    """``mom = momentum mom - (1 - momentum) g; weight += lr (sign(mom) -
    wd_lh weight)``; ``wd`` does not enter, as in the JAX op."""
    g = clipped_multi(grads, rescale_grad, clip_gradient)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_sub_(moms, torch._foreach_mul(g, 1 - momentum))
    step = torch._foreach_sign(moms)
    torch._foreach_sub_(step, torch._foreach_mul(weights, wd_lh))
    torch._foreach_mul_(step, lrs)
    torch._foreach_add_(weights, step)


@torch.no_grad()
def ftml_update_multi(weights, grads, ds, vs, zs, coefs, v_corrs, wds,
                      beta1=0.6, beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                      clip_grad=None):
    """FTML; each member's ``coef = (1 - beta1^t) / lr`` and ``v_corr = 1 -
    beta2^t`` come from the host in double, where the JAX op computes
    them: ``v = beta2 v + (1 - beta2) g^2``, ``d_t = coef (sqrt(v /
    v_corr) + eps)``, ``z = beta1 z + (1 - beta1) g - (d_t - beta1 d)
    weight``, ``weight = -z / d_t``, ``d = d_t``."""
    g = apply_wd_multi(weights, grads, wds, rescale_grad, clip_grad)
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_mul_(vs, beta2)
    torch._foreach_add_(vs, sq)
    d_t = torch._foreach_div(vs, v_corrs)
    torch._foreach_sqrt_(d_t)
    torch._foreach_add_(d_t, epsilon)
    torch._foreach_mul_(d_t, coefs)
    sigma = torch._foreach_sub(d_t, torch._foreach_mul(ds, beta1))
    torch._foreach_mul_(zs, beta1)
    torch._foreach_add_(zs, torch._foreach_mul(g, 1 - beta1))
    torch._foreach_sub_(zs, torch._foreach_mul(sigma, weights))
    new_w = torch._foreach_neg(zs)
    torch._foreach_div_(new_w, d_t)
    torch._foreach_copy_(weights, new_w)
    torch._foreach_copy_(ds, d_t)


@torch.no_grad()
def adagrad_update_multi(weights, grads, histories, lrs, wds, epsilon=1e-7,
                         rescale_grad=1.0, clip_gradient=None):
    """The ``adagrad_update`` op: ``history += g^2`` (``g`` with weight
    decay), ``weight -= lr g / (sqrt(history) + eps)``.  (The ``AdaGrad``
    optimizer follows its own formula: ``optimizer.py``.)"""
    g = apply_wd_multi(weights, grads, wds, rescale_grad, clip_gradient)
    torch._foreach_add_(histories, torch._foreach_mul(g, g))
    den = torch._foreach_sqrt(histories)
    torch._foreach_add_(den, epsilon)
    step = torch._foreach_mul(g, lrs)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(weights, step)


@torch.no_grad()
def adamw_update(weight, grad, mean, var, lr, eta=1.0, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None):
    """AdamW (``_contrib_adamw_update``): decoupled weight decay, ``weight
    -= eta * (lr * mean / (sqrt(var) + eps) + wd * weight)``; the decay is
    scaled by ``eta`` only.  ``rescale_grad`` may be a tensor (AMP's
    loss-scale reciprocal)."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g.clamp_(-clip_gradient, clip_gradient)
    mean.mul_(beta1).add_(g * (1 - beta1))
    var.mul_(beta2).add_((g * g).mul_(1 - beta2))
    upd = mean.mul(lr).div_(var.sqrt().add_(epsilon)).add_(weight * wd)
    weight.sub_(upd.mul_(eta))


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """Nesterov momentum, in place (:func:`nag_mom_update_multi`)."""
    nag_mom_update_multi([weight], [grad], [mom], [lr], [wd], momentum,
                         rescale_grad, clip_gradient)


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None, clip_weights=None):
    """RMSProp (Tieleman), in place (:func:`rmsprop_update_multi`)."""
    rmsprop_update_multi([weight], [grad], [n], [lr], [wd], gamma1, epsilon,
                         rescale_grad, clip_gradient, clip_weights)


def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=None, clip_weights=None):
    """Centered RMSProp, in place (:func:`rmspropalex_update_multi`)."""
    rmspropalex_update_multi([weight], [grad], [n], [g], [delta], [lr],
                             [wd], gamma1, gamma2, epsilon, rescale_grad,
                             clip_gradient, clip_weights)


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=None):
    """FTRL, in place (:func:`ftrl_update_multi`)."""
    ftrl_update_multi([weight], [grad], [z], [n], [lr], [wd], lamda1, beta,
                      rescale_grad, clip_gradient)


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
    """signSGD, in place (:func:`signsgd_update_multi`)."""
    signsgd_update_multi([weight], [grad], [lr], [wd], rescale_grad,
                         clip_gradient)


def signum_update(weight, grad, mom, lr, momentum=0.0, rescale_grad=1.0,
                  clip_gradient=None, wd_lh=0.0):
    """Signum, in place (:func:`signum_update_multi`)."""
    signum_update_multi([weight], [grad], [mom], [lr], momentum,
                        rescale_grad, clip_gradient, wd_lh)


def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=None):
    """FTML at step ``t``, in place (:func:`ftml_update_multi`)."""
    ftml_update_multi([weight], [grad], [d], [v], [z],
                      [(1 - beta1 ** t) / lr], [1 - beta2 ** t], [wd],
                      beta1, beta2, epsilon, rescale_grad, clip_grad)


def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """The ``adagrad_update`` op, in place (:func:`adagrad_update_multi`)."""
    adagrad_update_multi([weight], [grad], [history], [lr], [wd], epsilon,
                         rescale_grad, clip_gradient)


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
                   "mp_sgd_mom_update", "adam_update", "nag_mom_update",
                   "rmsprop_update", "rmspropalex_update", "ftrl_update",
                   "signsgd_update", "signum_update", "ftml_update",
                   "adagrad_update", "_sparse_adagrad_update",
                   "adamw_update", "_contrib_adamw_update")


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


@register("nag_mom_update")
def _nag_mom_update_op(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    nag_mom_update(weight, grad, mom, parse_float(lr),
                   parse_float(momentum, 0.0),
                   **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("rmsprop_update")
def _rmsprop_update_op(weight, grad, n, lr=None, gamma1=0.95, epsilon=1e-8,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    rmsprop_update(weight, grad, n, parse_float(lr),
                   parse_float(gamma1, 0.95), parse_float(epsilon, 1e-8),
                   clip_weights=parse_float(clip_weights),
                   **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("rmspropalex_update")
def _rmspropalex_update_op(weight, grad, n, g, delta, lr=None, gamma1=0.95,
                           gamma2=0.9, epsilon=1e-8, wd=0.0,
                           rescale_grad=1.0, clip_gradient=-1.0,
                           clip_weights=-1.0):
    rmspropalex_update(weight, grad, n, g, delta, parse_float(lr),
                       parse_float(gamma1, 0.95), parse_float(gamma2, 0.9),
                       parse_float(epsilon, 1e-8),
                       clip_weights=parse_float(clip_weights),
                       **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("ftrl_update")
def _ftrl_update_op(weight, grad, z, n, lr=None, lamda1=0.01, beta=1.0,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    ftrl_update(weight, grad, z, n, parse_float(lr),
                parse_float(lamda1, 0.01), parse_float(beta, 1.0),
                **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("signsgd_update")
def _signsgd_update_op(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    signsgd_update(weight, grad, parse_float(lr),
                   **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("signum_update")
def _signum_update_op(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    signum_update(weight, grad, mom, parse_float(lr),
                  parse_float(momentum, 0.0),
                  parse_float(rescale_grad, 1.0),
                  parse_float(clip_gradient), parse_float(wd_lh, 0.0))
    return weight


@register("ftml_update")
def _ftml_update_op(weight, grad, d, v, z, lr=None, beta1=0.6, beta2=0.999,
                    epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                    clip_grad=-1.0):
    ftml_update(weight, grad, d, v, z, parse_float(lr),
                parse_float(beta1, 0.6), parse_float(beta2, 0.999),
                parse_float(epsilon, 1e-8), parse_float(t, 1),
                parse_float(wd, 0.0), parse_float(rescale_grad, 1.0),
                parse_float(clip_grad))
    return weight


@register("_sparse_adagrad_update", aliases=("adagrad_update",))
def _adagrad_update_op(weight, grad, history, lr=None, epsilon=1e-7, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    adagrad_update(weight, grad, history, parse_float(lr),
                   parse_float(epsilon, 1e-7),
                   **_common(wd, rescale_grad, clip_gradient))
    return weight


@register("adamw_update", aliases=("_contrib_adamw_update",))
def _adamw_update_op(weight, grad, mean, var, *rescale, lr=None, eta=1.0,
                     beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                     clip_gradient=-1.0, rescale_grad=None):
    """``rescale_grad`` is an attribute or, as MXNet's op takes it, a
    fifth input (a one-element array)."""
    rs = rescale[0] if rescale else (1.0 if rescale_grad is None
                                      else parse_float(rescale_grad))
    adamw_update(weight, grad, mean, var, parse_float(lr),
                 parse_float(eta, 1.0), parse_float(beta1, 0.9),
                 parse_float(beta2, 0.999), parse_float(epsilon, 1e-8),
                 parse_float(wd, 0.0), rs, parse_float(clip_gradient))
    return weight


@register("all_finite", wrap_list=True)
def _all_finite_op(*arrays, init_output=True):
    return multi_all_finite(*arrays)


@register("multi_all_finite", wrap_list=True)
def _multi_all_finite_op(*arrays, num_arrays=1, init_output=True):
    return multi_all_finite(*arrays)
