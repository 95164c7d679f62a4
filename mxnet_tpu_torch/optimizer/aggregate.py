"""The grouped (multi-tensor) optimizer update (counterpart of
``mxnet_tpu/optimizer/aggregate.py``, its SGD rule).

MXNet 1.5 batches the updates of many small tensors into one launch
(``multi_sgd_mom_update``); the JAX package groups them into one jitted
call.  Here a group is the weights, gradients and momentum buffers of one
device and dtype, updated by a few ``torch._foreach_*`` calls (one launch
each for up to ``opt.aggregate_num`` tensors) that repeat the operations of
``ops/optimizer_ops.py`` in the same order, so the numbers are those of the
per-parameter path.  Members that cannot join a group (another optimizer
class, a gradient on another device or of another dtype, a tensor already
in the group) take the per-parameter path.
"""
from __future__ import annotations

import torch

from .optimizer import SGD

__all__ = ["update_multi"]


def _sgd_group(opt, indices, weights, grads, moms):
    opt._update_count(indices)
    lrs, wds = opt._get_lrs(indices), opt._get_wds(indices)
    g = torch._foreach_mul(grads, opt.rescale_grad)
    clip = opt.clip_gradient
    if clip is not None and clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    torch._foreach_add_(g, torch._foreach_mul(weights, wds))
    torch._foreach_mul_(g, lrs)
    if moms is None:
        torch._foreach_sub_(weights, g)
        return
    torch._foreach_mul_(moms, opt.momentum)
    torch._foreach_sub_(moms, g)
    torch._foreach_add_(weights, moms)


_RULES = {SGD: _sgd_group}


def _group_key(weight, grad, state):
    if grad.device != weight.device or grad.dtype != weight.dtype:
        return None
    return weight.device, weight.dtype, state is not None


@torch.no_grad()
def update_multi(opt, indices, weights, grads, states):
    """Apply ``opt`` to parallel lists of (index, weight, grad, state) in
    place, grouping what its rule can take."""
    rule = _RULES.get(type(opt))
    groups, fallback, taken = {}, [], set()
    for pos, (w, g, s) in enumerate(zip(weights, grads, states)):
        key = None if rule is None else _group_key(w, g, s)
        ptrs = {w.data_ptr()} | ({s.data_ptr()} if s is not None else set())
        if key is None or ptrs & taken:
            fallback.append(pos)
            continue
        taken |= ptrs
        groups.setdefault(key, []).append(pos)
    for (_, _, has_state), members in groups.items():
        for lo in range(0, len(members), opt.aggregate_num):
            chunk = members[lo:lo + opt.aggregate_num]
            rule(opt, [indices[p] for p in chunk],
                 [weights[p] for p in chunk], [grads[p] for p in chunk],
                 [states[p] for p in chunk] if has_state else None)
    for pos in fallback:
        opt.update(indices[pos], weights[pos], grads[pos], states[pos])
