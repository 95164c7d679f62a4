"""The grouped (multi-tensor) optimizer update (counterpart of
``mxnet_tpu/optimizer/aggregate.py``: its rules for SGD, Adam, NAG,
Signum, RMSProp, AdaGrad, Adamax, Nadam, FTML and Ftrl, :156-439).

MXNet 1.5 batches the updates of many small tensors into one launch
(``multi_sgd_mom_update``); the JAX package groups them into one jitted
call.  Here a group is the weights, gradients and states (SGD's momentum,
Adam's mean and variance) of one device and dtype, updated by a few
``torch._foreach_*`` calls (one launch each for up to ``opt.aggregate_num``
tensors) that repeat the operations of ``ops/optimizer_ops.py`` in the same
order, so the numbers are those of the per-parameter path, bit for bit.
Under ``multi_precision`` the fp16 weights form groups of their own
(``mxnet_tpu/optimizer/aggregate.py:483-553``): the rule runs on their
fp32 master copies with the gradients in fp32, and each weight then takes
its master's value, as ``update_multi_precision`` does one at a time.
Members that cannot join a group (another optimizer class, a gradient on
another device or of another dtype, a bare fp16 weight, a tensor already
in the group) take the per-parameter path.

The later optimizers' rules are their own ``_rule`` (``optimizer.py``,
the list-based functions of ``ops/optimizer_ops.py``), which their
per-parameter update runs on lists of one.  Nadam's momentum schedule is
one running product over members in the order they come, so Nadam groups
only when all members fall into one group, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..ops.optimizer_ops import apply_wd_multi
from .optimizer import (FTML, NAG, SGD, Adam, AdaGrad, Adamax, Ftrl, Nadam,
                        RMSProp, Signum)

__all__ = ["update_multi"]


def _apply_wd(opt, weights, grads, wds):
    """``_apply_wd`` of ``ops/optimizer_ops.py`` over a group."""
    return apply_wd_multi(weights, grads, wds, opt.rescale_grad,
                          opt.clip_gradient)


def sgd_group(opt, indices, weights, grads, moms):
    opt._update_count(indices)
    lrs, wds = opt._get_lrs(indices), opt._get_wds(indices)
    g = _apply_wd(opt, weights, grads, wds)
    torch._foreach_mul_(g, lrs)
    if moms is None:
        torch._foreach_sub_(weights, g)
        return
    torch._foreach_mul_(moms, opt.momentum)
    torch._foreach_sub_(moms, g)
    torch._foreach_add_(weights, moms)


def _adam_group(opt, indices, weights, grads, states):
    """``adam_update`` over a group; ``opt._get_lrs`` folds each index's
    bias correction into its lr, as ``_AdamRule.lrs`` does."""
    opt._update_count(indices)
    lrs, wds = opt._get_lrs(indices), opt._get_wds(indices)
    means, variances = [s[0] for s in states], [s[1] for s in states]
    g = _apply_wd(opt, weights, grads, wds)
    torch._foreach_mul_(means, opt.beta1)
    torch._foreach_add_(means, torch._foreach_mul(g, 1 - opt.beta1))
    torch._foreach_mul_(variances, opt.beta2)
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, 1 - opt.beta2)
    torch._foreach_add_(variances, g2)
    step = torch._foreach_mul(means, lrs)
    den = torch._foreach_sqrt(variances)
    torch._foreach_add_(den, opt.epsilon)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(weights, step)


def _own_rule(opt, indices, weights, grads, states):
    """The optimizer's ``_rule``; a group without states passes Nones."""
    opt._rule(indices, weights, grads,
              [None] * len(indices) if states is None else states)


# exact classes only: a subclass may override ``update``
_RULES = {SGD: sgd_group, Adam: _adam_group}
_RULES.update({cls: _own_rule for cls in (NAG, Signum, RMSProp, AdaGrad,
                                          Adamax, Nadam, FTML, Ftrl)})


def _tensors(state):
    """The tensors of a state: none, one buffer, or a tuple (Adam's, or a
    master copy and its inner state)."""
    if state is None:
        return ()
    if isinstance(state, torch.Tensor):
        return (state,)
    return tuple(t for s in state for t in _tensors(s))


def _group_key(opt, weight, grad, state):
    """(device, dtype, multi-precision, has a state) of a member that a
    group can take, else None."""
    if grad.device != weight.device or grad.dtype != weight.dtype:
        return None
    if weight.dtype == torch.float16:
        # fp16 joins a group only through its fp32 master copy
        if not (opt.multi_precision and isinstance(state, tuple)
                and len(state) == 2 and isinstance(state[0], torch.Tensor)
                and state[0].dtype == torch.float32):
            return None
        return weight.device, weight.dtype, True, state[1] is not None
    return weight.device, weight.dtype, False, state is not None


def _mp_group(rule, opt, indices, weights, grads, states):
    """``rule`` on the fp32 master copies, then each fp16 weight takes its
    master's value."""
    masters = [s[0] for s in states]
    inner = None if states[0][1] is None else [s[1] for s in states]
    rule(opt, indices, masters, [g.float() for g in grads], inner)
    for w, m in zip(weights, masters):
        w.copy_(m)


@torch.no_grad()
def update_multi(opt, indices, weights, grads, states):
    """Apply ``opt`` to parallel lists of (index, weight, grad, state) in
    place, grouping what its rule can take."""
    rule = _RULES.get(type(opt))
    groups, fallback, taken = {}, [], set()
    for pos, (w, g, s) in enumerate(zip(weights, grads, states)):
        key = None if rule is None else _group_key(opt, w, g, s)
        ptrs = {w.data_ptr()} | {t.data_ptr() for t in _tensors(s)}
        if key is None or ptrs & taken:
            fallback.append(pos)
            continue
        taken |= ptrs
        groups.setdefault(key, []).append(pos)
    if type(opt) is Nadam and (fallback or len(groups) > 1):
        fallback, groups = list(range(len(weights))), {}
    for (_, _, mp, has_state), members in groups.items():
        for lo in range(0, len(members), opt.aggregate_num):
            chunk = members[lo:lo + opt.aggregate_num]
            args = ([indices[p] for p in chunk], [weights[p] for p in chunk],
                    [grads[p] for p in chunk])
            if mp:
                _mp_group(rule, opt, *args, [states[p] for p in chunk])
            else:
                rule(opt, *args,
                     [states[p] for p in chunk] if has_state else None)
    for pos in fallback:
        opt.update_multi_precision(indices[pos], weights[pos], grads[pos],
                                   states[pos])
