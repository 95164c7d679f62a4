"""Every op of the port's table on the card against the CPU, and the two
kernel-backed ops against their plain versions.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package, so on a machine with the card it
runs without them:

    python -m pytest --noconftest -q tests/test_torch_nd_gpu.py

Each case of ``mxnet_tpu_torch/test_utils.py`` runs on ``mx.gpu(0)`` and on
``mx.cpu()`` from the same seeded inputs; outputs and gradients must agree
at the CPU tests' tolerances, and every output and gradient must lie on
the card.  The samplers are held by distribution (100k draws, 5 standard
errors) and by stream (the same seed, the same bits).
``nd.contrib.flash_attention`` at (8, 12, 128, 64) fp32 launches the flash
kernel exactly once and matches the plain version within 1e-4;
``nd.BatchNorm`` in training launches the bn-stats kernel exactly once.
TF32 is switched off so that fp32 means fp32.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import bn_stats as bs
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.test_utils import (OP_CASES, RANDOM_CASES, UPDATE_OPS,
                                        case_id, compare, make_inputs,
                                        run_case)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mx.gpu(0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", OP_CASES, ids=case_id)
def test_op_on_card_matches_cpu(cuda, case):
    got, ggot, where = run_case(mx.nd, mx.autograd, case, cuda)
    want, gwant, _ = run_case(mx.nd, mx.autograd, case, mx.cpu())
    assert all(c == cuda for c in where), where
    compare(case, got, want, f"{case.name} output")
    if case.grad:
        compare(case, ggot, gwant, f"{case.name} gradient")


@pytest.mark.gpu
@pytest.mark.parametrize("case", UPDATE_OPS, ids=case_id)
def test_update_op_on_card_matches_cpu(cuda, case):
    arrays = make_inputs(case)
    results = []
    for ctx in (cuda, mx.cpu()):
        xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
        out = getattr(mx.nd, case.name)(*xs, out=xs[0], **case.attrs)
        assert out is xs[0] and out.context == ctx
        results.append([x.asnumpy() for x in xs])
    for g, w in zip(*results):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("case", RANDOM_CASES, ids=lambda c: c[0])
def test_sampler_on_card(cuda, case):
    name, inputs, attrs, mean, var = case
    n = 100_000

    def draw(seed):
        mx.random.seed(seed)
        xs = [mx.nd.array(a, ctx=cuda) for a in inputs]
        return getattr(mx.nd, name)(*xs, ctx=cuda, shape=(n,), **attrs)

    a = draw(7)
    assert a.context == cuda
    np.testing.assert_array_equal(a.asnumpy(), draw(7).asnumpy())
    s = a.asnumpy().astype(np.float64).reshape(-1)
    m4 = ((s - s.mean()) ** 4).mean()
    assert abs(s.mean() - mean) <= 5 * np.sqrt(var / s.size)
    assert abs(s.var() - var) <= 5 * np.sqrt((m4 - s.var() ** 2) / s.size)


@pytest.mark.gpu
def test_shuffle_on_card(cuda):
    draws = []
    for _ in range(2):
        mx.random.seed(3)
        draws.append(mx.nd.random.shuffle(mx.nd.arange(1000, ctx=cuda)))
    assert draws[0].context == cuda
    a = draws[0].asnumpy()
    np.testing.assert_array_equal(np.sort(a), np.arange(1000))
    np.testing.assert_array_equal(a, draws[1].asnumpy())
    assert not np.array_equal(a, np.arange(1000))


@pytest.mark.gpu
def test_nd_flash_attention_launches_the_kernel_once(cuda):
    rng = np.random.RandomState(0)
    q, k, v = (mx.nd.array(rng.randn(8, 12, 128, 64), ctx=cuda)
               for _ in range(3))
    before = fa.flash_attention.launches
    out = mx.nd.contrib.flash_attention(q, k, v, causal=False)
    out.wait_to_read()
    assert fa.flash_attention.launches - before == 1
    assert out.context == cuda and out.shape == (8, 12, 128, 64)
    ref = fa._reference(q.data, k.data, v.data, False, 1 / 8)
    assert (out.data - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_nd_batchnorm_training_launches_bn_stats_once(cuda):
    rng = np.random.RandomState(1)
    x = rng.randn(8, 64, 28, 28).astype("float32")
    args = [x, rng.uniform(0.5, 2, 64), rng.randn(64), np.zeros(64),
            np.ones(64)]
    results = []
    for ctx in (cuda, mx.cpu()):
        xs = [mx.nd.array(a, ctx=ctx) for a in args]
        before = bs.bn_stats.launches
        with mx.autograd.record():
            out = mx.nd.BatchNorm(*xs, fix_gamma=False)
        out.wait_to_read()
        launched = bs.bn_stats.launches - before
        assert launched == (1 if ctx == cuda else 0)
        results.append([out.asnumpy(), xs[3].asnumpy(), xs[4].asnumpy()])
    for g, w in zip(*results):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5)
