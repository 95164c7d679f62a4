"""The port's samplers (``mx.nd.random``, ``_sample_*``, ``shuffle``,
``Dropout``) by distribution, on the CPU.

The two packages draw different bits (a ``torch.Generator`` per device
against a ``jax.random`` key), so each sampler is held, in both packages,
to the distribution's mean and variance: n = 100k draws within 5 standard
errors (the variance's standard error from the sample's fourth moment).
KS tests mirror ``tests/test_random_statistics.py`` where a continuous CDF
applies.  The same seed must give the same stream bitwise, and
``mx.random.seed`` must also fix ``gluon.nn.Dropout`` and the initializer.
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.test_utils import RANDOM_CASES

N = 100_000


def _draw(pkg, name, inputs, attrs, seed=1234):
    pkg.random.seed(seed)
    kw = dict(attrs, shape=(N,))
    if pkg is mx:
        xs = [mx.nd.array(a, ctx=mx.cpu()) for a in inputs]
        return getattr(mx.nd, name)(*xs, ctx=mx.cpu(), **kw)
    return getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in inputs], **kw)


def _within_5_se(s, mean, var):
    s = s.astype(np.float64).reshape(-1)
    n = s.size
    m, v = s.mean(), s.var()
    m4 = ((s - m) ** 4).mean()
    se_m, se_v = np.sqrt(var / n), np.sqrt(max(m4 - v * v, 1e-30) / n)
    assert abs(m - mean) <= 5 * se_m, (m, mean, se_m)
    assert abs(v - var) <= 5 * se_v, (v, var, se_v)


@pytest.mark.parametrize("case", RANDOM_CASES, ids=lambda c: c[0])
def test_sampler_moments_in_both_packages(case):
    name, inputs, attrs, mean, var = case
    ours = _draw(mx, name, inputs, attrs)
    assert ours.context == mx.cpu()
    _within_5_se(ours.asnumpy(), mean, var)
    _within_5_se(_draw(jmx, name, inputs, attrs).asnumpy(), mean, var)


@pytest.mark.parametrize("case", RANDOM_CASES, ids=lambda c: c[0])
def test_same_seed_same_stream(case):
    name, inputs, attrs, _, _ = case
    a = _draw(mx, name, inputs, attrs, seed=7).asnumpy()
    b = _draw(mx, name, inputs, attrs, seed=7).asnumpy()
    np.testing.assert_array_equal(a, b)
    xs = [mx.nd.array(x, ctx=mx.cpu()) for x in inputs]
    c = getattr(mx.nd, name)(*xs, ctx=mx.cpu(), shape=(N,), **attrs)
    assert not np.array_equal(a, c.asnumpy())    # the stream moved on


@pytest.mark.parametrize("name, attrs, cdf, args", [
    ("uniform", {"low": -2.0, "high": 3.0}, "uniform", (-2.0, 5.0)),
    ("normal", {"loc": 1.5, "scale": 2.0}, "norm", (1.5, 2.0)),
    ("gamma", {"alpha": 2.5, "beta": 1.5}, "gamma", (2.5, 0, 1.5)),
    ("exponential", {"lam": 2.0}, "expon", (0, 0.5)),
])
def test_continuous_samplers_pass_ks(name, attrs, cdf, args):
    mx.random.seed(1234)
    s = getattr(mx.nd.random, name)(shape=(60_000,), ctx=mx.cpu(), **attrs)
    stat, p = st.kstest(s.asnumpy(), cdf, args=args)
    assert p > 1e-3, (stat, p)


def test_samplers_take_dtype_and_ranges():
    with mx.cpu():
        r = mx.nd.random.randint(-3, 4, shape=(1000,))
        assert r.dtype == np.int32
        assert r.asnumpy().min() >= -3 and r.asnumpy().max() < 4
        u = mx.nd.random.uniform(0, 1, shape=(3, 4), dtype="float16")
        assert u.dtype == np.float16 and u.shape == (3, 4)
        m = mx.nd.random.multinomial(mx.nd.array([[0.0, 1.0, 0.0]]),
                                     shape=(5,), get_prob=True)
        assert m[0].asnumpy().tolist() == [[1] * 5]
        np.testing.assert_allclose(m[1].asnumpy(), 0.0, atol=1e-6)
        with pytest.raises(ValueError, match="positive"):
            mx.nd.random.exponential(lam=-1.0, shape=(2,))


def test_shuffle_is_a_permutation():
    mx.random.seed(3)
    x = mx.nd.array(np.arange(40).reshape(20, 2), ctx=mx.cpu())
    y = mx.nd.random.shuffle(x).asnumpy()
    assert sorted(y[:, 0].tolist()) == list(range(0, 40, 2))
    np.testing.assert_array_equal(y[:, 1] - y[:, 0], 1)
    assert not np.array_equal(y, x.asnumpy())


def test_dropout_in_training_by_distribution():
    x = mx.nd.ones((200, 500), ctx=mx.cpu())
    with mx.autograd.record():
        y = mx.nd.Dropout(x, p=0.3).asnumpy()
    kept = y != 0
    vals = np.unique(y)
    assert len(vals) == 2 and vals[0] == 0.0
    np.testing.assert_allclose(vals[1], 1 / 0.7, rtol=1e-6)
    _within_5_se(kept.astype(np.float64), 0.7, 0.21)
    with mx.autograd.record():
        rows = mx.nd.Dropout(x, p=0.5, axes=(1,)).asnumpy()
    assert (rows == rows[:, :1]).all()           # one mask per row


def test_seed_fixes_dropout_and_initializer():
    def run():
        mx.random.seed(11)
        net = gluon.nn.Dense(4, in_units=3, device="cpu")
        net.initialize()
        drop = gluon.nn.Dropout(0.5)
        with mx.autograd.record():
            out = drop(net(torch.ones(2, 3)))
        nd_draw = mx.nd.random.normal(shape=(3,), ctx=mx.cpu()).asnumpy()
        return net.weight.detach().numpy().copy(), out.detach().numpy(), \
            nd_draw
    first, second = run(), run()
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_generators_are_per_device():
    mx.random.seed(5)
    g = mx.random.generator(torch.device("cpu"))
    assert g is mx.random.generator("cpu")
    assert g.device == torch.device("cpu")
    mx.random.seed(6, ctx=mx.cpu())
    assert mx.random.generator("cpu") is not g
