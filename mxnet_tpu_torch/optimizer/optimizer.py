"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``, the part
the training slices need): the ``Optimizer`` base with its registry,
per-parameter multipliers, learning-rate scheduler and ``multi_precision``
route (an fp32 master copy of each fp16 weight), ``SGD``, ``Adam``,
``create``, ``Updater`` and ``get_updater``.

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

from ..ops import optimizer_ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "create", "get_updater",
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
