"""The decode sampler: greedy, or Gumbel-max on a counter-based stream.

The JAX model's ``sample_math`` (``mxnet_tpu/serving/decode/model.py:391``)
draws the noise of request ``key`` at token index ``step`` as
``jax.random.uniform(fold_in(key, step), (vocab,), 1e-7, 1.0)``.  Here the
same stream is computed with the same function, JAX's threefry2x32 (20
rounds, counter mode): ``fold_in`` on the host for the batch's keys, the
``(B, vocab)`` counters with torch integer ops on the logits' device.  The
uniforms equal JAX's bit for bit (``tests/test_torch_decode_model.py``);
``-log(-log(u))`` then runs on torch's ``log``, which may differ from
XLA's in the last bit.

So a token is a pure function of (request seed, token index, logits row):
it depends on no other row, on no bucket and on no scheduling, on the CPU
and on the card alike.  An all-greedy batch skips the noise, as the JAX
program's ``lax.cond`` does; the result is the same either way.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample", "fold_in", "threefry2x32", "uniform"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MINVAL = np.float32(1e-7)
_SPAN = np.float32(1.0) - _MINVAL       # maxval - minval, in float32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """JAX's ``threefry2x32`` on unsigned 32-bit words held in int64
    (numpy or torch, broadcasting): returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(keys, steps):
    """``jax.random.fold_in(key, step)`` of each row (host arrays): keys
    ``(B, 2)`` uint32, steps ``(B,)``; returns ``(B, 2)`` int64 words."""
    keys = np.asarray(keys, np.uint32).astype(np.int64).reshape(-1, 2)
    steps = np.asarray(steps).astype(np.int64).reshape(-1) & _M32
    f0, f1 = threefry2x32(keys[:, 0], keys[:, 1], np.zeros_like(steps),
                          steps)
    return np.stack([f0, f1], axis=1)


def uniform(folded, n, device):
    """``jax.random.uniform(key, (n,), minval=1e-7, maxval=1.0)`` for each
    row of ``folded`` (``(B, 2)`` int64 from :func:`fold_in`): ``(B, n)``
    float32 on ``device``.  JAX's partitionable counters (the index's high
    and low words) and its ``bits1 ^ bits2``; the affine map is one fused
    multiply-add, as XLA emits it, done in float64 and rounded once."""
    k = torch.from_numpy(np.ascontiguousarray(folded)).to(device)
    lo = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    b0, b1 = threefry2x32(k[:, 0:1], k[:, 1:2], torch.zeros_like(lo), lo)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    u = (f.double() * float(_SPAN) + float(_MINVAL)).float()
    return u.clamp_min(float(_MINVAL))


def sample(logits, keys, steps, temps):
    """Next token of each row of ``logits (B, V)``: argmax at ``temp ==
    0``, else ``argmax(logits / temp + gumbel)`` on the row's stream.
    ``keys``, ``steps`` and ``temps`` are host arrays; returns an int32
    tensor on the logits' device."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    temps = np.asarray(temps, np.float32).reshape(-1)
    hot = temps > 0
    if not hot.any():
        return greedy
    u = uniform(fold_in(keys, steps), logits.shape[-1], logits.device)
    g = -torch.log(-torch.log(u))
    t = torch.from_numpy(np.where(hot, temps, np.float32(1.0))[:, None]
                         ).to(logits.device)
    sampled = (logits / t + g).argmax(dim=-1).to(torch.int32)
    return torch.where(torch.from_numpy(hot).to(logits.device), sampled,
                       greedy)
