"""Training written in ``mx.nd`` alone, in the port against the JAX package
on the CPU, and the two kernel-backed ops called through the table.

- The canonical eager drive (the JAX package's verify notes, "Eager
  training loop"): a two-layer MLP in ``nd.*`` with ``attach_grad``,
  ``backward`` and ``nd.sgd_update(w, w.grad, out=w, ...)``, 5 steps from
  the same weights in both packages; losses within 1e-5 (relative) and the
  final weights within 1e-5 of each tensor's largest magnitude.
- ``nd.contrib.flash_attention`` at T=128 (the JAX package runs its Pallas
  kernel in interpret mode; the port its plain version on the CPU),
  output and gradients at fp32 rtol 1e-5 / atol 1e-6.
- ``nd.BatchNorm`` in training mode: output, gradients and the moving
  statistics it writes back (momentum 0.9), against the JAX package.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

STEPS, LR = 5, 0.5


def _mlp_run(pkg, ctx, weights, x, y):
    nd, ag = pkg.nd, pkg.autograd
    params = [nd.array(w, ctx=ctx) for w in weights]
    for p in params:
        p.attach_grad()
    data, label = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
    losses = []
    for _ in range(STEPS):
        w1, b1, w2, b2 = params
        with ag.record():
            h = nd.relu(nd.FullyConnected(data, w1, b1, num_hidden=16))
            out = nd.FullyConnected(h, w2, b2, num_hidden=3)
            loss = -nd.pick(nd.log_softmax(out), label).mean()
        loss.backward()
        for p in params:
            nd.sgd_update(p, p.grad, out=p, lr=LR, wd=1e-4)
        losses.append(float(loss.asscalar()))
    return losses, [p.asnumpy() for p in params]


def test_nd_only_mlp_trains_like_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(32, 8).astype("float32")
    y = (x[:, 0] > 0).astype("float32") + (x[:, 1] > 0)
    weights = [rng.randn(16, 8).astype("float32") * 0.3,
               np.zeros(16, "float32"),
               rng.randn(3, 16).astype("float32") * 0.3,
               np.zeros(3, "float32")]
    pl, pw = _mlp_run(mx, mx.cpu(), weights, x, y)
    jl, jw = _mlp_run(jmx, jmx.cpu(), weights, x, y)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    for p, j in zip(pw, jw):
        np.testing.assert_allclose(p, j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("causal", [False, True])
def test_nd_flash_attention_matches_jax_interpret(causal):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 2, 128, 16).astype("float32") for _ in range(3))
    hg = rng.randn(2, 2, 128, 16).astype("float32")

    def run(pkg, ctx):
        xs = [pkg.nd.array(a, ctx=ctx) for a in (q, k, v)]
        for x in xs:
            x.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.contrib.flash_attention(*xs, causal=causal)
        out.backward(pkg.nd.array(hg, ctx=ctx))
        return [out.asnumpy()] + [x.grad.asnumpy() for x in xs]

    for got, want in zip(run(mx, mx.cpu()), run(jmx, jmx.cpu())):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_nd_batchnorm_training_writes_moving_stats_like_jax():
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 3, 5, 5) * 2 + 1).astype("float32")
    gamma = rng.uniform(0.5, 2, 3).astype("float32")
    beta = rng.randn(3).astype("float32")
    mm, mv = rng.randn(3).astype("float32"), \
        rng.uniform(0.5, 2, 3).astype("float32")
    hg = rng.randn(*x.shape).astype("float32")

    def run(pkg, ctx):
        nd = pkg.nd
        xs = [nd.array(a, ctx=ctx) for a in (x, gamma, beta)]
        moving = [nd.array(mm, ctx=ctx), nd.array(mv, ctx=ctx)]
        for t in xs:
            t.attach_grad()
        with pkg.autograd.record():
            out = nd.BatchNorm(*xs, *moving, fix_gamma=False, momentum=0.9,
                               eps=1e-3)
        out.backward(nd.array(hg, ctx=ctx))
        with_stats = nd.BatchNorm(*xs, *moving, fix_gamma=False,
                                  output_mean_var=True)   # predict mode
        return [out.asnumpy()] + [t.grad.asnumpy() for t in xs] + \
            [m.asnumpy() for m in moving] + [o.asnumpy() for o in with_stats]

    got, want = run(mx, mx.cpu()), run(jmx, jmx.cpu())
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"result {i}")
    # the moving statistics moved towards the batch's
    np.testing.assert_allclose(got[4], 0.9 * mm + 0.1 * x.mean((0, 2, 3)),
                               rtol=1e-5)
