"""Random sampling ops (counterpart of ``mxnet_tpu/ops/random_ops.py``).

The JAX package's samplers take a ``jax.random`` key as their first input.
Here each takes ``generator=``, the ``torch.Generator`` of the device it
samples on, which ``ndarray/register.py`` passes for every name in
:data:`STOCHASTIC_OPS` (``mx.random.seed`` resets them).  The ``_random_*``
ops make their output on ``ctx``; the ``_sample_*`` ops draw one batch of
``shape`` per element of their parameter arrays, on those arrays' device.
Gamma-Poisson mixtures give the negative binomials, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..base import parse_bool, parse_float, parse_int, parse_tuple, \
    torch_dtype
from ..context import as_device
from .registry import register

STOCHASTIC_OPS = set()


def _register_random(name, aliases=()):
    def deco(fn):
        register(name, aliases=aliases)(fn)
        STOCHASTIC_OPS.update((name,) + tuple(aliases))
        return fn
    return deco


def _shape_dtype(shape, dtype, default="float32"):
    shape = parse_tuple(shape) if shape is not None else (1,)
    return shape, torch_dtype(dtype if dtype not in (None, "None")
                              else default)


def _require_positive(name, value, allow_zero=False):
    """Distribution parameters are checked at the call, as MXNet's
    parameter structs check them."""
    v = float(value)
    if v < 0 or (v == 0 and not allow_zero):
        raise ValueError(f"random sampler parameter {name}={v} must be "
                         f"{'non-negative' if allow_zero else 'positive'}")


def _full(value, shape, device):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


def _gamma(alpha, generator):
    """Gamma(alpha, 1) samples, one per element of the tensor ``alpha``."""
    return torch._standard_gamma(alpha, generator=generator)


@_register_random("_random_uniform", aliases=("uniform", "random_uniform"))
def random_uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None,
                   generator=None):
    shape, dt = _shape_dtype(shape, dtype)
    lo, hi = parse_float(low, 0.0), parse_float(high, 1.0)
    u = torch.rand(shape, generator=generator, device=as_device(ctx))
    return (u * (hi - lo) + lo).to(dt)


@_register_random("_random_normal", aliases=("normal", "random_normal"))
def random_normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None,
                  generator=None):
    shape, dt = _shape_dtype(shape, dtype)
    scale = parse_float(scale, 1.0)
    _require_positive("scale", scale, allow_zero=True)
    n = torch.randn(shape, generator=generator, device=as_device(ctx))
    return (n * scale + parse_float(loc, 0.0)).to(dt)


@_register_random("_random_gamma", aliases=("random_gamma",))
def random_gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None,
                 generator=None):
    shape, dt = _shape_dtype(shape, dtype)
    a, b = parse_float(alpha, 1.0), parse_float(beta, 1.0)
    _require_positive("alpha", a)
    _require_positive("beta", b)
    return (_gamma(_full(a, shape, as_device(ctx)), generator) * b).to(dt)


@_register_random("_random_exponential",
                  aliases=("exponential", "random_exponential"))
def random_exponential(lam=1.0, shape=None, dtype=None, ctx=None,
                       generator=None):
    shape, dt = _shape_dtype(shape, dtype)
    lam = parse_float(lam, 1.0)
    _require_positive("lam", lam)
    e = torch.empty(shape, device=as_device(ctx)).exponential_(
        1.0, generator=generator)
    return (e / lam).to(dt)


@_register_random("_random_poisson", aliases=("poisson", "random_poisson"))
def random_poisson(lam=1.0, shape=None, dtype=None, ctx=None,
                   generator=None):
    shape, dt = _shape_dtype(shape, dtype)
    lam = parse_float(lam, 1.0)
    _require_positive("lam", lam, allow_zero=True)
    return torch.poisson(_full(lam, shape, as_device(ctx)),
                         generator=generator).to(dt)


def _gamma_poisson(shape_param, scale, generator):
    """Poisson(Gamma(shape_param) * scale): the negative binomial."""
    return torch.poisson(_gamma(shape_param, generator) * scale,
                         generator=generator)


@_register_random("_random_negative_binomial",
                  aliases=("negative_binomial", "random_negative_binomial"))
def random_negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None,
                             generator=None):
    shape, dt = _shape_dtype(shape, dtype)
    kk, pp = parse_float(k, 1), parse_float(p, 1.0)
    return _gamma_poisson(_full(kk, shape, as_device(ctx)),
                          (1 - pp) / pp, generator).to(dt)


@_register_random("_random_generalized_negative_binomial",
                  aliases=("generalized_negative_binomial",
                           "random_generalized_negative_binomial"))
def random_gen_neg_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                            ctx=None, generator=None):
    shape, dt = _shape_dtype(shape, dtype)
    mu_, a_ = parse_float(mu, 1.0), parse_float(alpha, 1.0)
    return _gamma_poisson(_full(1.0 / a_, shape, as_device(ctx)),
                          a_ * mu_, generator).to(dt)


@_register_random("_random_randint", aliases=("randint", "random_randint"))
def random_randint(low=0, high=1, shape=None, dtype=None, ctx=None,
                   generator=None):
    shape, dt = _shape_dtype(shape, dtype, default="int32")
    return torch.randint(parse_int(low, 0), parse_int(high, 1), shape,
                         generator=generator, dtype=dt,
                         device=as_device(ctx))


@_register_random("_random_bernoulli", aliases=("sample_bernoulli",))
def random_bernoulli(p=0.5, shape=None, dtype=None, ctx=None,
                     generator=None):
    shape, dt = _shape_dtype(shape, dtype)
    return torch.bernoulli(_full(parse_float(p, 0.5), shape, as_device(ctx)),
                           generator=generator).to(dt)


def _per_element(p, shape):
    """Parameter array ``p`` broadcast to ``p.shape + shape`` in float32."""
    return p.float().reshape(p.shape + (1,) * len(shape)).expand(
        tuple(p.shape) + shape)


def _sample_shape(shape):
    return parse_tuple(shape) if shape else ()


def _out_dtype(dtype):
    return torch_dtype(dtype or "float32")


@_register_random("_sample_uniform", aliases=("sample_uniform",))
def sample_uniform(low, high, shape=None, dtype=None, generator=None):
    shape = _sample_shape(shape)
    lo, hi = _per_element(low, shape), _per_element(high, shape)
    u = torch.rand(lo.shape, generator=generator, device=lo.device)
    return (lo + u * (hi - lo)).to(_out_dtype(dtype))


@_register_random("_sample_normal", aliases=("sample_normal",))
def sample_normal(mu, sigma, shape=None, dtype=None, generator=None):
    shape = _sample_shape(shape)
    m, s = _per_element(mu, shape), _per_element(sigma, shape)
    n = torch.randn(m.shape, generator=generator, device=m.device)
    return (m + n * s).to(_out_dtype(dtype))


@_register_random("_sample_gamma", aliases=("sample_gamma",))
def sample_gamma(alpha, beta, shape=None, dtype=None, generator=None):
    shape = _sample_shape(shape)
    a, b = _per_element(alpha, shape), _per_element(beta, shape)
    return (_gamma(a.contiguous(), generator) * b).to(_out_dtype(dtype))


@_register_random("_sample_poisson", aliases=("sample_poisson",))
def sample_poisson(lam, shape=None, dtype=None, generator=None):
    lam = _per_element(lam, _sample_shape(shape)).contiguous()
    return torch.poisson(lam, generator=generator).to(_out_dtype(dtype))


@_register_random("_sample_exponential", aliases=("sample_exponential",))
def sample_exponential(lam, shape=None, dtype=None, generator=None):
    lam = _per_element(lam, _sample_shape(shape))
    e = torch.empty(lam.shape, device=lam.device).exponential_(
        1.0, generator=generator)
    return (e / lam).to(_out_dtype(dtype))


@_register_random("_sample_negative_binomial",
                  aliases=("sample_negative_binomial",))
def sample_negative_binomial(k, p, shape=None, dtype=None, generator=None):
    shape = _sample_shape(shape)
    kk, pp = _per_element(k, shape), _per_element(p, shape)
    return _gamma_poisson(kk.contiguous(), (1.0 - pp) / pp, generator) \
        .to(_out_dtype(dtype))


@_register_random("_sample_generalized_negative_binomial",
                  aliases=("sample_generalized_negative_binomial",))
def sample_generalized_negative_binomial(mu, alpha, shape=None, dtype=None,
                                         generator=None):
    shape = _sample_shape(shape)
    m, a = _per_element(mu, shape), _per_element(alpha, shape)
    return _gamma_poisson((1.0 / a.clamp_min(1e-12)).contiguous(), a * m,
                          generator).to(_out_dtype(dtype))


@_register_random("_sample_multinomial", aliases=("sample_multinomial",))
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                       generator=None):
    """Class indices drawn from the last axis of ``data`` (probabilities);
    ``shape`` draws that many per distribution; ``get_prob`` also returns
    each draw's log-probability."""
    n = parse_tuple(shape)[0] if shape else 1
    k = data.shape[-1]
    probs = data.float().reshape(-1, k)
    out = torch.multinomial(probs, n, replacement=True, generator=generator)
    out = out.reshape(tuple(data.shape[:-1]) + (n,))
    if shape is None:
        out = out[..., 0]
    if parse_bool(get_prob):
        logp = torch.log_softmax(torch.log(data.float().clamp_min(1e-37)), -1)
        lp = torch.gather(logp, -1, out if shape is not None
                          else out[..., None])
        return out.to(torch_dtype(dtype)), \
            lp if shape is not None else lp[..., 0]
    return out.to(torch_dtype(dtype))


@_register_random("_shuffle", aliases=("shuffle",))
def shuffle(data, generator=None):
    """Permute along the first axis."""
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]
