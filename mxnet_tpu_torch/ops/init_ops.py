"""Creation ops (counterpart of ``mxnet_tpu/ops/init_ops.py``).

Each makes its tensor on ``ctx`` (a Context or torch device; ``None`` is the
current context), which ``ndarray/register.py`` passes from the caller's
``ctx=``: a created tensor is made where it is wanted, never moved there.
"""
from __future__ import annotations

import torch

from ..base import (parse_bool, parse_float, parse_int, parse_tuple,
                    torch_dtype)
from ..context import as_device
from .registry import register


@register("_zeros")
def _zeros(shape=None, ctx=None, dtype="float32"):
    return torch.zeros(parse_tuple(shape), dtype=torch_dtype(dtype),
                       device=as_device(ctx))


@register("_ones")
def _ones(shape=None, ctx=None, dtype="float32"):
    return torch.ones(parse_tuple(shape), dtype=torch_dtype(dtype),
                      device=as_device(ctx))


@register("_full")
def _full(shape=None, value=0.0, ctx=None, dtype="float32"):
    return torch.full(parse_tuple(shape), parse_float(value, 0.0),
                      dtype=torch_dtype(dtype), device=as_device(ctx))


@register("_arange")
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            ctx=None, dtype="float32"):
    start = parse_float(start, 0.0)
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, parse_float(stop), parse_float(step, 1.0),
                       dtype=torch_dtype(dtype), device=as_device(ctx))
    r = parse_int(repeat, 1)
    return out.repeat_interleave(r) if r > 1 else out


@register("_linspace", aliases=("linspace",))
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, ctx=None,
              dtype="float32"):
    n = parse_int(num, 50)
    endpoint = parse_bool(endpoint, True)
    out = torch.linspace(parse_float(start), parse_float(stop),
                         n if endpoint else n + 1, dtype=torch.float32,
                         device=as_device(ctx))
    return (out if endpoint else out[:n]).to(torch_dtype(dtype))


@register("_eye")
def _eye(N=0, M=0, k=0, ctx=None, dtype="float32"):
    n = parse_int(N)
    m = parse_int(M, 0) or n
    device = as_device(ctx)
    rows = torch.arange(n, device=device)[:, None] + parse_int(k, 0)
    return (rows == torch.arange(m, device=device)[None, :]) \
        .to(torch_dtype(dtype))
