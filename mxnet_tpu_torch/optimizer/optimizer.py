"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``): the
``Optimizer`` base with its registry, per-parameter multipliers,
learning-rate scheduler and ``multi_precision`` route (an fp32 master copy
of each fp16 weight), the sixteen optimizers of MXNet 1.5 (``SGD``,
``Signum``, ``FTML``, ``LBSGD``, ``DCASGD``, ``NAG``, ``SGLD``, ``ccSGD``,
``Adam``, ``AdaGrad``, ``RMSProp``, ``AdaDelta``, ``Ftrl``, ``Adamax``,
``Nadam``, ``Test``), ``create``, ``Updater`` and ``get_updater``.

Updates are in place on the weight and state tensors
(``ops/optimizer_ops.py``); ``Updater`` hands a batch of parameters to the
grouped ``torch._foreach_*`` path (``aggregate.py``) when the optimizer has
a rule there.
"""
from __future__ import annotations

import math
import pickle
import warnings

import torch

from .. import random as _random
from ..ops import optimizer_ops

__all__ = ["AdaDelta", "AdaGrad", "Adam", "Adamax", "DCASGD", "FTML", "Ftrl",
           "LBSGD", "NAG", "Nadam", "Optimizer", "RMSProp", "SGD", "SGLD",
           "Signum", "Test", "Updater", "ccSGD", "create", "get_updater",
           "register"]


class Optimizer:
    """Base optimizer (``mxnet_tpu/optimizer/optimizer.py:63``): learning
    rate and weight decay with per-parameter multipliers, per-index update
    counts, ``rescale_grad`` and ``clip_gradient``.  With an
    ``lr_scheduler`` (``mx.lr_scheduler``) the learning rate is the
    scheduler's at the current ``num_update``; the scheduler's ``base_lr``
    becomes ``learning_rate``.

    ``aggregate_num`` caps the parameters of one grouped update; 1 or less
    keeps the per-parameter path.

    ``multi_precision`` (``mxnet_tpu/optimizer/optimizer.py:65-135``): an
    fp16 weight gets an fp32 master copy in its state, the update runs on
    the master with the gradient in fp32, and the weight takes the
    master's value.  It acts on fp16 weights only; an fp16 weight without
    it warns when its state is made."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            warnings.warn(f"New optimizer {klass.__name__} is overriding "
                          f"existing optimizer {name}")
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.multi_precision = multi_precision
        self.clip_gradient = clip_gradient
        self.aggregate_num = 256
        self.lr, self.wd = learning_rate, wd
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        if param_idx2name is not None and not isinstance(param_idx2name,
                                                         dict):
            raise TypeError("param_idx2name should be a dict of param "
                            "indexes to names")
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    def __getstate__(self):
        # a Trainer's Parameters are not pickled with the optimizer:
        # ``Trainer.load_states`` attaches the loading Trainer's own
        state = self.__dict__.copy()
        state["param_dict"] = {}
        return state

    def create_state(self, index, weight):
        """Auxiliary state for ``weight`` (None when there is none)."""

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _wants_master_weight(self, weight):
        """True for an fp16 weight under ``multi_precision``; a bare fp16
        weight warns, as the JAX package's does."""
        if weight.dtype != torch.float16:
            return False
        if self.multi_precision:
            return True
        warnings.warn("Accumulating with float16 in optimizer can lead to "
                      "poor accuracy or slow convergence. "
                      "Consider using multi_precision=True option of the "
                      "optimizer")
        return False

    def create_state_multi_precision(self, index, weight):
        """:meth:`create_state`, or for an fp16 weight under
        ``multi_precision`` ``(fp32 master copy, create_state(master))``."""
        if not self._wants_master_weight(weight):
            return self.create_state(index, weight)
        master = weight.detach().to(torch.float32, copy=True)
        return master, self.create_state(index, master)

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, or for an fp16 weight under ``multi_precision``
        the update of its master copy, which the weight then takes."""
        if not (self.multi_precision and weight.dtype == torch.float16):
            return self.update(index, weight, grad, state)
        master, inner = state
        self.update(index, master, grad.float(), inner)
        weight.copy_(master)

    def update_multi(self, indices, weights, grads, states):
        """The grouped update over parallel lists (``aggregate.py``)."""
        from . import aggregate
        aggregate.update_multi(self, indices, weights, grads, states)

    def set_learning_rate(self, lr):
        """Set the learning rate; refused when a scheduler owns it
        (``mxnet_tpu/optimizer/optimizer.py:142-150``)."""
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined. Note "
                "that set_learning_rate can mutate the value of the learning "
                "rate of the optimizer only when the LRScheduler of the "
                "optimizer is undefined.")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers by index or name."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight-decay multipliers by index or name.  Named parameters
        (``param_idx2name``, the Module path) that end neither in
        ``_weight`` nor ``_gamma`` default to 0."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        indices = index if isinstance(index, (list, tuple)) else (index,)
        counts = self._index_update_count
        for idx in indices:
            counts[idx] = counts.get(idx, self.begin_num_update) + 1
            self.num_update = max(counts[idx], self.num_update)

    def _begin_update(self, index, grad):
        """The preamble of the optimizers written without an update op
        (``mxnet_tpu/optimizer/optimizer.py:176-185``): count the update,
        then ``(lr, wd, clip(rescale_grad * grad))``."""
        self._update_count(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return self._get_lr(index), self._get_wd(index), g

    def _param_mult(self, index, table, attr):
        """The multiplier's precedence (``optimizer.py:189-225``): an
        attached Gluon ``Parameter`` wins, then an index-keyed entry, then a
        name-keyed one; default 1."""
        param = self.param_dict.get(index)
        if param is not None:
            return getattr(param, attr)
        if index in table:
            return table[index]
        name = self.idx2name.get(index)
        return table.get(name, 1.0) if name is not None else 1.0

    def _get_lrs(self, indices):
        base = self.learning_rate
        return [base * self._param_mult(i, self.lr_mult, "lr_mult")
                for i in indices]

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        return [self.wd * self._param_mult(i, self.wd_mult, "wd_mult")
                for i in indices]

    def _get_wd(self, index):
        return self._get_wds([index])[0]


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum > 0``
    (``mxnet_tpu/optimizer/optimizer.py:238``): the state is the momentum
    buffer, and ``lr`` is folded into it as MXNet's kernel does.  Under
    ``multi_precision`` an fp16 weight takes ``mp_sgd_update`` /
    ``mp_sgd_mom_update``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, False)

    def update_multi_precision(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state,
                          self.multi_precision
                          and weight.dtype == torch.float16)

    def _update_impl(self, index, weight, grad, state, multi_precision):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=self.clip_gradient)
        if multi_precision:
            master, mom = state
            if mom is not None:
                optimizer_ops.mp_sgd_mom_update(weight, grad, mom, master,
                                                momentum=self.momentum,
                                                **kwargs)
            else:
                optimizer_ops.mp_sgd_update(weight, grad, master, **kwargs)
        elif state is not None:
            optimizer_ops.sgd_mom_update(weight, grad, state,
                                         momentum=self.momentum, **kwargs)
        else:
            optimizer_ops.sgd_update(weight, grad, **kwargs)


@register
class Adam(Optimizer):
    """Adam (``mxnet_tpu/optimizer/optimizer.py:563``): the states are the
    mean and the variance, and the bias correction is folded into the
    learning rate with the parameter's own update count ``t``,
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``.

    ``lazy_update`` is accepted for MXNet's signature.  The reference's
    lazy branch updates only the rows of a row-sparse gradient; the port
    has no row-sparse gradients, so every update here is the dense one."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.lazy_update = epsilon, lazy_update

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def _get_lrs(self, indices):
        """The bias-corrected learning rates, after ``_update_count``."""
        out = []
        for lr, i in zip(super()._get_lrs(indices), indices):
            t = self._index_update_count[i]
            out.append(lr * (math.sqrt(1. - self.beta2 ** t)
                             / (1. - self.beta1 ** t)))
        return out

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        optimizer_ops.adam_update(
            weight, grad, mean, var, lr=self._get_lr(index),
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
            wd=self._get_wd(index), rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient)


def _zeros(weight):
    return torch.zeros_like(weight)


def _op_kwargs(opt, clip_name="clip_gradient"):
    """``rescale_grad`` and, when it is set (truthy), the clip, as the JAX
    optimizers pass them to their update ops."""
    kw = {"rescale_grad": opt.rescale_grad}
    if opt.clip_gradient:
        kw[clip_name] = opt.clip_gradient
    return kw


class _Grouped:
    """An optimizer whose update is one list-based rule, ``_rule(indices,
    weights, grads, states)``: the per-parameter update is the rule on
    lists of one and the grouped update (``aggregate.py``) the same rule
    on a group, so the two give the same bits."""

    def update(self, index, weight, grad, state):
        self._rule([index], [weight], [grad], [state])


@register
class Signum(_Grouped, Optimizer):
    """signSGD, and Signum with ``momentum`` (``mxnet_tpu/optimizer/
    optimizer.py:294``): ``signum_update`` / ``signsgd_update``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _rule(self, indices, weights, grads, states):
        self._update_count(indices)
        lrs = self._get_lrs(indices)
        kw = _op_kwargs(self)
        if states[0] is None:
            optimizer_ops.signsgd_update_multi(
                weights, grads, lrs, self._get_wds(indices), **kw)
        else:
            optimizer_ops.signum_update_multi(
                weights, grads, states, lrs, self.momentum,
                wd_lh=self.wd_lh, **kw)


@register
class FTML(_Grouped, Optimizer):
    """FTML (``mxnet_tpu/optimizer/optimizer.py:324``): ``ftml_update``
    with the parameter's own update count ``t``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight), _zeros(weight)  # d, v, z

    def _rule(self, indices, weights, grads, states):
        self._update_count(indices)
        lrs, wds = self._get_lrs(indices), self._get_wds(indices)
        ts = [self._index_update_count[i] for i in indices]
        d, v, z = ([s[k] for s in states] for k in range(3))
        optimizer_ops.ftml_update_multi(
            weights, grads, d, v, z,
            [(1. - self.beta1 ** t) / lr for t, lr in zip(ts, lrs)],
            [1. - self.beta2 ** t for t in ts], wds, self.beta1, self.beta2,
            self.epsilon, **_op_kwargs(self, "clip_grad"))


@register
class LBSGD(Optimizer):
    """Large-batch SGD (``mxnet_tpu/optimizer/optimizer.py:351``): the
    gradients of ``batch_scale`` updates are summed, then one SGD step at
    ``lr`` times a warm-up multiplier (``linear``, ``power2``, ``sqrt``)
    or the LARS trust ratio (``warmup_strategy="lars"``).  The summed
    gradient is a copy, not the gradient buffer itself."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy, self.warmup_epochs = warmup_strategy, \
            warmup_epochs
        self.batch_scale, self.updates_per_epoch = batch_scale, \
            updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.cumgrads = {}

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _get_lbmult(self, nup):
        """1 -> ``batch_scale`` over the warm-up updates along the curve."""
        span = self.warmup_epochs * self.updates_per_epoch
        target = float(self.batch_scale)
        if nup >= span:
            return target
        if span <= 1:
            return 1.0
        frac = float(nup) / span
        curve = {"linear": frac, "power2": frac * frac,
                 "sqrt": math.sqrt(frac)}.get(self.warmup_strategy)
        return 1.0 if curve is None else 1.0 + (target - 1.0) * curve

    def _get_lars(self, weight, g, wd):
        """``sqrt(|w|^2 / (|g|^2 + wd |w|^2))`` clamped to [0.01, 100]."""
        w2 = float((weight * weight).sum())
        g2 = float((g * g).sum())
        return min(max(math.sqrt(w2 / (g2 + wd * w2 + 1e-18)), 0.01), 100.0)

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        prev = self.cumgrads.get(index)
        if prev and prev["num_cums"] > 0:
            cgrad = {"cum_grad": prev["cum_grad"] + grad,
                     "num_cums": prev["num_cums"] + 1}
        else:
            cgrad = {"cum_grad": grad.clone(),
                     "num_cums": self.init_updates + 1}
        self.cumgrads[index] = cgrad
        if cgrad["num_cums"] % self.batch_scale:
            return
        g = cgrad["cum_grad"] / self.batch_scale
        lr *= self._get_lars(weight, g, wd) \
            if self.warmup_strategy == "lars" \
            else self._get_lbmult(cgrad["num_cums"])
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient or None)
        if state is not None:
            optimizer_ops.sgd_mom_update(weight, g, state,
                                         momentum=self.momentum, **kw)
        else:
            optimizer_ops.sgd_update(weight, g, **kw)
        cgrad["cum_grad"] = 0


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD (``mxnet_tpu/optimizer/optimizer.py:469``):
    the state is the momentum (or None) and the previous weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        mom = _zeros(weight) if self.momentum != 0.0 else None
        return mom, weight.detach().clone()

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, grad = self._begin_update(index, grad)
        mom, previous = state
        step = -lr * (grad + wd * weight + self.lamda * grad * grad
                      * (weight - previous))
        if mom is not None:
            mom.mul_(self.momentum).add_(step)
            step = mom
        previous.copy_(weight)
        weight.add_(step)


@register
class NAG(_Grouped, Optimizer):
    """Nesterov accelerated SGD (``mxnet_tpu/optimizer/optimizer.py:
    500``): ``nag_mom_update``, or ``sgd_update`` without momentum."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _rule(self, indices, weights, grads, states):
        if states[0] is None:
            from .aggregate import sgd_group
            return sgd_group(self, indices, weights, grads, None)
        self._update_count(indices)
        optimizer_ops.nag_mom_update_multi(
            weights, grads, states, self._get_lrs(indices),
            self._get_wds(indices), self.momentum, **_op_kwargs(self))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (``mxnet_tpu/optimizer/
    optimizer.py:527``): ``weight -= lr / 2 (g + wd weight)``, then
    Gaussian noise of variance ``lr`` from the weight's device generator
    (``mx.random.seed``)."""

    def create_state(self, index, weight):
        return None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd, grad = self._begin_update(index, grad)
        weight.sub_(lr / 2 * (grad + wd * weight))
        noise = torch.empty_like(weight).normal_(
            0, math.sqrt(lr), generator=_random.generator(weight.device))
        weight.add_(noise)


@register
class ccSGD(SGD):  # noqa: N801 (MXNet's name)
    """[Deprecated] SGD under another name."""


@register
class AdaGrad(_Grouped, Optimizer):
    """AdaGrad (``mxnet_tpu/optimizer/optimizer.py:600``): ``history +=
    g^2`` (``g`` without weight decay), ``weight -= lr (g / sqrt(history +
    eps) + wd weight)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def _rule(self, indices, weights, grads, states):
        self._update_count(indices)
        lrs, wds = self._get_lrs(indices), self._get_wds(indices)
        g = optimizer_ops.clipped_multi(grads, self.rescale_grad,
                                   self.clip_gradient)
        torch._foreach_add_(states, torch._foreach_mul(g, g))
        den = torch._foreach_add(states, self.float_stable_eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(g, den)
        torch._foreach_add_(g, torch._foreach_mul(weights, wds))
        torch._foreach_mul_(g, [-lr for lr in lrs])
        torch._foreach_add_(weights, g)


@register
class RMSProp(_Grouped, Optimizer):
    """RMSProp, plain (Tieleman) or ``centered`` (Graves)
    (``mxnet_tpu/optimizer/optimizer.py:632``): ``rmsprop_update`` /
    ``rmspropalex_update``; ``clip_weights`` bounds the weights."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered, self.epsilon = centered, epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return _zeros(weight), _zeros(weight), _zeros(weight)
        return (_zeros(weight),)

    def _rule(self, indices, weights, grads, states):
        self._update_count(indices)
        lrs, wds = self._get_lrs(indices), self._get_wds(indices)
        kw = dict(_op_kwargs(self), clip_weights=self.clip_weights or None)
        if self.centered:
            n, g, delta = ([s[k] for s in states] for k in range(3))
            optimizer_ops.rmspropalex_update_multi(
                weights, grads, n, g, delta, lrs, wds, self.gamma1,
                self.gamma2, self.epsilon, **kw)
        else:
            optimizer_ops.rmsprop_update_multi(
                weights, grads, [s[0] for s in states], lrs, wds,
                self.gamma1, self.epsilon, **kw)


@register
class AdaDelta(Optimizer):
    """AdaDelta (``mxnet_tpu/optimizer/optimizer.py:677``): accumulated
    squared gradients and updates, in float32 whatever the weight's
    dtype, as there."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        z = torch.zeros(weight.shape, device=weight.device)
        return z, z.clone()

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _lr, wd, grad = self._begin_update(index, grad)
        acc_g, acc_delta = state
        acc_g.copy_(self.rho * acc_g + (1. - self.rho) * grad * grad)
        delta = (torch.sqrt(acc_delta + self.epsilon)
                 / torch.sqrt(acc_g + self.epsilon)) * grad
        acc_delta.copy_(self.rho * acc_delta
                        + (1. - self.rho) * delta * delta)
        weight.copy_(weight - delta - wd * weight)


@register
class Ftrl(_Grouped, Optimizer):
    """FTRL-proximal (``mxnet_tpu/optimizer/optimizer.py:704``):
    ``ftrl_update`` with the state ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def _rule(self, indices, weights, grads, states):
        self._update_count(indices)
        optimizer_ops.ftrl_update_multi(
            weights, grads, [s[0] for s in states], [s[1] for s in states],
            self._get_lrs(indices), self._get_wds(indices), self.lamda1,
            self.beta, **_op_kwargs(self))


@register
class Adamax(_Grouped, Optimizer):
    """AdaMax, Adam with the infinity norm (``mxnet_tpu/optimizer/
    optimizer.py:730``): ``m = beta1 m + (1 - beta1) g``, ``u =
    max(beta2 u, |g|)``, ``weight -= lr / (1 - beta1^t) m / u``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    @torch.no_grad()
    def _rule(self, indices, weights, grads, states):
        self._update_count(indices)
        lrs = [lr / (1. - self.beta1 ** self._index_update_count[i])
               for lr, i in zip(self._get_lrs(indices), indices)]
        g = optimizer_ops.apply_wd_multi(weights, grads,
                                         self._get_wds(indices),
                                         self.rescale_grad,
                                         self.clip_gradient)
        m, u = [s[0] for s in states], [s[1] for s in states]
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1. - self.beta1))
        torch._foreach_mul_(u, self.beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(g))
        step = torch._foreach_mul(m, lrs)
        torch._foreach_div_(step, u)
        torch._foreach_sub_(weights, step)


@register
class Nadam(_Grouped, Optimizer):
    """Nesterov Adam (``mxnet_tpu/optimizer/optimizer.py:758``).  The
    momentum schedule ``m_schedule`` is one product over every update of
    every parameter, in the order they come, as there."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.schedule_decay = epsilon, schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    @torch.no_grad()
    def _rule(self, indices, weights, grads, states):
        self._update_count(indices)
        lrs, wds = self._get_lrs(indices), self._get_wds(indices)
        b1, b2 = self.beta1, self.beta2
        mom_t, mom_t1, g_corr, m_corr, v_corr = [], [], [], [], []
        for i in indices:
            t = self._index_update_count[i]
            mt = b1 * (1. - 0.5 * (pow(0.96, t * self.schedule_decay)))
            mt1 = b1 * (1. - 0.5 * (pow(0.96, (t + 1)
                                        * self.schedule_decay)))
            self.m_schedule = self.m_schedule * mt
            mom_t.append(1. - mt)
            mom_t1.append(mt1)
            g_corr.append(1. - self.m_schedule)
            m_corr.append(1. - self.m_schedule * mt1)
            v_corr.append(1. - pow(b2, t))
        # rescale, add the weight decay, then clip, as the JAX optimizer
        g = torch._foreach_mul(grads, self.rescale_grad)
        torch._foreach_add_(g, torch._foreach_mul(weights, wds))
        g = optimizer_ops.clipped_multi(g, 1.0, self.clip_gradient)
        m, v = [s[0] for s in states], [s[1] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1. - b1))
        torch._foreach_mul_(v, b2)
        sq = torch._foreach_mul(g, 1. - b2)
        torch._foreach_mul_(sq, g)
        torch._foreach_add_(v, sq)
        g_prime = torch._foreach_div(g, g_corr)
        m_prime = torch._foreach_div(m, m_corr)
        v_prime = torch._foreach_div(v, v_corr)
        m_bar = torch._foreach_mul(g_prime, mom_t)
        torch._foreach_add_(m_bar, torch._foreach_mul(m_prime, mom_t1))
        torch._foreach_mul_(m_bar, lrs)
        den = torch._foreach_sqrt(v_prime)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(m_bar, den)
        torch._foreach_sub_(weights, m_bar)


@register
class Test(Optimizer):
    """The reference's test optimizer: ``weight += rescale_grad * grad``,
    and the state takes the weight's value."""

    def create_state(self, index, weight):
        return torch.zeros(weight.shape, device=weight.device)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.add_(grad * self.rescale_grad)
        state.copy_(weight)


create = Optimizer.create_optimizer


def _state_to(state, device):
    """An optimizer state (a tensor, a tuple of them or None) on
    ``device``."""
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, (tuple, list)):
        return type(state)(_state_to(s, device) for s in state)
    return state


class Updater:
    """Per-index optimizer state, made on first update
    (``mxnet_tpu/optimizer/optimizer.py:799``).  A call with several
    indices takes the grouped path when the optimizer aggregates.
    ``get_states``/``set_states`` pickle the states on the CPU; loaded
    states move to their weight's device at its next update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self._loaded = False

    def __call__(self, index, grad, weight):
        batched = isinstance(index, (list, tuple))
        indices = list(index) if batched else [index]
        weights = list(weight) if batched else [weight]
        grads = list(grad) if batched else [grad]
        for idx, w in zip(indices, weights):
            if idx not in self.states:
                self.states[idx] = \
                    self.optimizer.create_state_multi_precision(idx, w)
            elif self._loaded:
                self.states[idx] = _state_to(self.states[idx], w.device)
        states = [self.states[idx] for idx in indices]
        if len(indices) > 1 and self.optimizer.aggregate_num > 1:
            self.optimizer.update_multi(indices, weights, grads, states)
        else:
            for idx, w, g, s in zip(indices, weights, grads, states):
                self.optimizer.update_multi_precision(idx, w, g, s)

    def get_states(self, dump_optimizer=False):
        """The states (and with ``dump_optimizer`` the optimizer) as
        pickled bytes, tensors on the CPU."""
        states = {k: _state_to(v, "cpu") for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states):
        """Load what :meth:`get_states` wrote."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self._loaded = True


def get_updater(optimizer):
    return Updater(optimizer)
