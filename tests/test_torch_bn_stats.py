"""BatchNorm batch statistics and training-mode ``batch_norm`` of the port
against the JAX package, on the CPU.

The TPU kernel (``benchmark/pallas_bn_stats.py``) is a closure inside that
script's ``main()``; what it is measured against there is ``xla_stats``,
the formulation of ``mxnet_tpu.ops.nn.batch_norm``'s training branch.  So
the port's plain statistics (what ``bn_stats`` runs on a CPU tensor) and
its training-mode ``batch_norm`` are held against
``mxnet_tpu.ops.nn.batch_norm(..., __training__=True)`` and its
``jax.vjp``, on the same numpy inputs.  fp32 throughout; tolerances are
stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import nn as jops

from mxnet_tpu_torch.ops import bn_stats as bs
from mxnet_tpu_torch.ops import nn as ops


def _data(shape, seed=0, mean=0.5, std=2.0, axis=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * std + mean).astype("float32")
    c = shape[axis]
    gamma = rng.uniform(0.5, 1.5, c).astype("float32")
    beta = rng.randn(c).astype("float32")
    return x, gamma, beta


def _jax_train(x, gamma, beta, axis, fix_gamma, eps=1e-5):
    c = x.shape[axis]

    def f(xx, gg, bb):
        return jops.batch_norm(xx, gg, bb, jnp.zeros(c), jnp.ones(c),
                               eps=eps, fix_gamma=fix_gamma, axis=axis,
                               __training__=True)
    return jax.vjp(f, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))


@pytest.mark.parametrize("shape", [(4, 3, 5, 6), (2, 5, 7, 7), (3, 4)])
def test_plain_stats_match_jax(shape):
    """Shifted by the training pivot, the plain statistics are JAX's batch
    mean and biased variance (atol 1e-5 on O(1) values)."""
    x, gamma, beta = _data(shape)
    (_, mean, var), _ = _jax_train(x, gamma, beta, 1, False)
    xt = torch.from_numpy(x)
    pivot = xt[(0, slice(None)) + (0,) * (x.ndim - 2)].contiguous()
    m, v = bs.bn_stats(xt, pivot)
    assert m.dtype == v.dtype == torch.float32 and m.shape == (shape[1],)
    np.testing.assert_allclose(m.numpy(), np.asarray(mean), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(var), rtol=0, atol=1e-5)
    # unshifted: the TPU kernel's own function, E[x^2] - E[x]^2
    m0, v0 = bs.bn_stats(xt)
    x64 = x.astype("float64").reshape(shape[0], shape[1], -1)
    np.testing.assert_allclose(m0.numpy(), x64.mean((0, 2)), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(v0.numpy(), x64.var((0, 2)), rtol=0,
                               atol=1e-4)


def test_pivot_keeps_large_mean_exact():
    """Mean 1000, std 1: the unshifted fp32 E[x^2] - E[x]^2 loses the
    variance (1e6 squared to 1e6 with a 0.06 ulp), the pivot keeps it
    within 1e-4 of the float64 value."""
    x, _, _ = _data((8, 4, 6, 6), seed=3, mean=1000.0, std=1.0)
    x64 = x.astype("float64").reshape(8, 4, -1)
    xt = torch.from_numpy(x)
    m, v = bs.bn_stats(xt, xt[0, :, 0, 0].contiguous())
    np.testing.assert_allclose(v.numpy(), x64.var((0, 2)), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(m.numpy(), x64.mean((0, 2)), rtol=1e-7,
                               atol=0)
    _, v_unshifted = bs.bn_stats(xt)
    assert np.abs(v_unshifted.numpy() - x64.var((0, 2))).max() > 1e-2


@pytest.mark.parametrize("axis,shape", [(1, (4, 3, 5, 6)), (3, (2, 5, 6, 4)),
                                        (1, (2, 6, 7, 7)), (1, (6, 5))])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("mean", [0.5, 1000.0])
def test_training_batch_norm_and_grads_match_jax(axis, shape, fix_gamma,
                                                 mean):
    """Output, batch mean and variance, and the input/gamma/beta gradients
    of the training branch against JAX's op and ``jax.vjp``.  The output is
    O(1): atol 1e-4 (2e-3 with mean 1000, where x - mean itself carries
    fp32's 6e-5 ulp at 1000); mean and var rtol 1e-5 and atol 1e-4;
    gradients atol 1e-4 of their largest magnitude (same: 2e-3 at mean
    1000)."""
    x, gamma, beta = _data(shape, seed=1, mean=mean,
                           std=2.0 if mean < 100 else 1.0, axis=axis)
    (out, bmean, bvar), vjp = _jax_train(x, gamma, beta, axis, fix_gamma)
    dy = np.random.RandomState(2).randn(*shape).astype("float32")
    jdx, jdg, jdb = vjp((jnp.asarray(dy), jnp.zeros(x.shape[axis]),
                         jnp.zeros(x.shape[axis])))

    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in
                  (x, gamma, beta))
    c = x.shape[axis]
    o, m, v = ops.batch_norm(xt, gt, bt, torch.zeros(c), torch.ones(c),
                             1e-5, fix_gamma, axis, training=True)
    o.backward(torch.from_numpy(dy))
    tol = 1e-4 if mean < 100 else 2e-3
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(bmean),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(bvar),
                               rtol=1e-5, atol=1e-4)
    for port, ref in ((xt.grad, jdx), (bt.grad, jdb)) + \
            (() if fix_gamma else ((gt.grad, jdg),)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
    if fix_gamma:
        assert gt.grad is None or not gt.grad.any()


def test_returned_stats_carry_no_gradient_like_jax():
    """The batch mean and variance feed ``out``'s gradient (the test above)
    but, as returned, take none: JAX stops their gradient, and so does the
    port."""
    x, gamma, beta = _data((3, 4, 5, 5), seed=4)
    _, vjp = _jax_train(x, gamma, beta, 1, False)
    jdx = vjp((jnp.zeros(x.shape), jnp.ones(4), jnp.ones(4)))[0]
    assert not np.asarray(jdx).any()
    xt = torch.from_numpy(x).requires_grad_()
    out, m, v = ops.batch_norm(xt, torch.from_numpy(gamma),
                               torch.from_numpy(beta), None, None, 1e-5,
                               False, 1, training=True)
    assert out.requires_grad and not m.requires_grad and not v.requires_grad


def test_moving_stats_update_matches_register_writeback():
    """``update_moving_stats`` is ``register.py``'s write-back:
    ``m * moving + (1 - m) * batch`` with the biased variance (atol 1e-6)."""
    from mxnet_tpu.ndarray.register import _batchnorm_writeback
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag

    rng = np.random.RandomState(7)
    mm, mv, bm, bv = (rng.rand(5).astype("float32") for _ in range(4))
    jm, jv = jmx.nd.array(mm), jmx.nd.array(mv)
    with jag.train_mode():
        _batchnorm_writeback([None, None, None, jm, jv],
                             [None, jmx.nd.array(bm), jmx.nd.array(bv)],
                             {"momentum": 0.7})
    tm, tv = torch.from_numpy(mm.copy()), torch.from_numpy(mv.copy())
    ops.update_moving_stats(tm, tv, torch.from_numpy(bm),
                            torch.from_numpy(bv), 0.7)
    np.testing.assert_allclose(tm.numpy(), jm.asnumpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), jv.asnumpy(), rtol=0, atol=1e-6)


def _check_case(case):
    x = torch.zeros(2, 3, 4, 5)
    return {
        "nchw": (x, None, 1),
        "nhwc": (x, bs.FIRST, 3),
        "channels_last": (x.to(memory_format=torch.channels_last),
                          torch.zeros(3), 1),
        "fp16": (x.half(), bs.FIRST, 1),
        "bf16": (x.bfloat16(), None, 3),
        "int": (x.int(), None, 1),
        "float64": (x.double(), None, 1),
        "1d": (torch.zeros(6), None, 0),
        "empty": (torch.zeros(0, 3, 4), None, 1),
        "strided": (x[:, :, :, ::2], None, 1),
        "pivot_shape": (x, torch.zeros(4), 1),
        "pivot_dtype": (x, torch.zeros(3, dtype=torch.float64), 1),
        "pivot_strided": (x, torch.zeros(6)[::2], 1),
        "pivot_name": (x, "last", 1),
    }[case]


@pytest.mark.parametrize("case,want", [
    ("nchw", "cf"), ("nhwc", "cl"), ("channels_last", "cl"), ("fp16", "cf"),
    ("bf16", "cl"), ("int", TypeError), ("float64", TypeError),
    ("1d", ValueError), ("empty", ValueError), ("strided", ValueError),
    ("pivot_shape", ValueError), ("pivot_dtype", ValueError),
    ("pivot_strided", ValueError), ("pivot_name", ValueError)])
def test_check_takes_only_what_the_kernel_reads(case, want):
    """The check before a launch: the kernel's layout for the dtypes,
    layouts and pivots it reads, and an error for anything else (the
    wrapper copies and casts nothing)."""
    x, pivot, axis = _check_case(case)
    if isinstance(want, str):
        assert bs._check(x, pivot, axis) == want
    else:
        with pytest.raises(want):
            bs._check(x, pivot, axis)


def test_bn_stats_takes_only_cpu_or_cuda():
    x = torch.ones(2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bs.bn_stats(x)


@pytest.mark.parametrize("layout", ["channels_last", "strided"])
def test_training_batch_norm_takes_any_layout(layout, monkeypatch):
    """A ``channels_last`` input reaches the statistics as it lies (the
    kernel's channels-last entry reads it), a strided view as one
    contiguous NCHW copy (counted in ``bn_stats.copies``), and both give
    JAX's output and gradients (the tolerances of the test above)."""
    x, gamma, beta = _data((4, 3, 5, 6), seed=5)
    (out, bmean, bvar), vjp = _jax_train(x, gamma, beta, 1, False)
    dy = np.random.RandomState(6).randn(*x.shape).astype("float32")
    jdx, jdg, jdb = vjp((jnp.asarray(dy), jnp.zeros(3), jnp.zeros(3)))

    seen = []
    real = bs.bn_stats

    def spy(t, p=None, axis=1):
        seen.append(bs.layout(t, axis))
        return real(t, p, axis)
    spy.copies = 0
    monkeypatch.setattr(bs, "bn_stats", spy)
    if layout == "channels_last":
        leaf = torch.from_numpy(x).to(memory_format=torch.channels_last) \
            .requires_grad_()
        xt = leaf
        assert not xt.is_contiguous()
    else:
        wide = np.zeros((4, 3, 5, 12), "float32")
        wide[..., ::2] = x
        leaf = torch.from_numpy(wide).requires_grad_()
        xt = leaf[..., ::2]
    gt, bt = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
    o, m, v = ops.batch_norm(xt, gt, bt, torch.zeros(3), torch.ones(3),
                             1e-5, False, 1, training=True)
    o.backward(torch.from_numpy(dy))
    assert seen == (["cl"] if layout == "channels_last" else ["cf"])
    assert spy.copies == (layout == "strided")
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(bmean), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(bvar), rtol=1e-5,
                               atol=1e-4)
    dx = leaf.grad if layout == "channels_last" else leaf.grad[..., ::2]
    for port, ref in ((dx, jdx), (gt.grad, jdg), (bt.grad, jdb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


# ------------------------------------------------------- channels last
@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (2, 7, 7, 64), (3, 4, 130),
                                   (1, 1, 1, 8), (2, 3, 2, 2, 5)])
def test_channels_last_plain_stats_match_jax_and_nchw(shape):
    """The plain statistics over a channel-last tensor (the kernel's
    channels-last entry on the card) with the NHWC pivot ``x[0, 0, 0, c]``:
    JAX's ``BatchNorm(axis=-1)`` batch statistics (rtol 1e-5, atol 1e-5),
    and the channel-first plain version on the transposed data, whose
    pivot is the same element, within 1e-6 (variance 0.25: a few fp32
    steps of another summation order); an NCHW-shaped tensor in
    ``channels_last`` memory takes the kernel's same entry and gives the
    same within 1e-6."""
    x, gamma, beta = _data(shape, seed=8, std=0.5, axis=-1)
    ax = len(shape) - 1
    (_, mean, var), _ = _jax_train(x, gamma, beta, ax, False)
    xt = torch.from_numpy(x)
    assert bs.layout(xt, ax) == "cl"
    pivot = xt[(0,) * ax].contiguous()
    m, v = bs.bn_stats(xt, pivot, ax)
    np.testing.assert_allclose(m.numpy(), np.asarray(mean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(var), rtol=1e-5,
                               atol=1e-5)
    cf = xt.movedim(ax, 1).contiguous()
    m1, v1 = bs.bn_stats(cf, cf[(0, slice(None)) + (0,) * (ax - 1)]
                         .contiguous())
    np.testing.assert_allclose(m.numpy(), m1.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), v1.numpy(), rtol=0, atol=1e-6)
    if len(shape) == 4 and shape[1] * shape[2] > 1:
        # (with 1x1 maps both layouts are contiguous: the NCHW entry)
        cl = xt.permute(0, 3, 1, 2)
        assert cl.is_contiguous(memory_format=torch.channels_last)
        assert bs.layout(cl, 1) == "cl"
        m2, v2 = bs.bn_stats(cl, pivot)
        np.testing.assert_allclose(m2.numpy(), m.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(v2.numpy(), v.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (2, 9, 4), (2, 3, 4, 2, 6)])
def test_batch_norm_last_axis_grad_matches_jax(shape):
    """``batch_norm(axis=-1)`` in training, NWC, NHWC and NDHWC: output,
    statistics and the input/gamma/beta gradients against JAX's op and
    ``jax.vjp`` (the tolerances of the NCHW test above); nothing is
    copied."""
    x, gamma, beta = _data(shape, seed=9, axis=-1)
    c = shape[-1]
    (out, bmean, bvar), vjp = _jax_train(x, gamma, beta, -1, False)
    dy = np.random.RandomState(10).randn(*shape).astype("float32")
    jdx, jdg, jdb = vjp((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in
                  (x, gamma, beta))
    copies = bs.bn_stats.copies
    o, m, v = ops.batch_norm(xt, gt, bt, torch.zeros(c), torch.ones(c),
                             1e-5, False, -1, training=True)
    o.backward(torch.from_numpy(dy))
    assert bs.bn_stats.copies == copies
    assert o.is_contiguous()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(bmean), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(bvar), rtol=1e-5,
                               atol=1e-4)
    for port, ref in ((xt.grad, jdx), (gt.grad, jdg), (bt.grad, jdb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_gluon_batchnorm_axis3_folds_moving_stats_like_jax():
    """``nn.BatchNorm(axis=3)`` in training: output and the moving
    statistics after two batches against the JAX package's layer
    (atol 1e-5), the statistics on the channel axis."""
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch.gluon import nn

    rng = np.random.RandomState(11)
    xs = [(rng.randn(3, 4, 5, 6) * 2 + 1).astype("float32") for _ in range(2)]
    jbn = jgluon.nn.BatchNorm(axis=3, momentum=0.8)
    jbn.initialize()
    bn = nn.BatchNorm(axis=3, momentum=0.8, device="cpu")
    bn.initialize()
    for x in xs:
        with jag.record():
            jo = jbn(jmx.nd.array(x))
        with ag.record():
            o = bn(torch.from_numpy(x))
        np.testing.assert_allclose(o.detach().numpy(), jo.asnumpy(), rtol=0,
                                   atol=1e-5)
    assert bn.running_mean.tensor().shape == (6,)
    np.testing.assert_allclose(bn.running_mean.tensor().numpy(),
                               jbn.running_mean.data().asnumpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.tensor().numpy(),
                               jbn.running_var.data().asnumpy(), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------ own pivot, layout
@pytest.mark.parametrize("shape,axis", [((4, 3, 5, 6), 1), ((2, 7, 7, 64), 3),
                                        ((3, 4, 130), 2), ((5, 9), 1)])
def test_own_pivot_is_the_explicit_pivot_on_the_cpu(shape, axis):
    """``pivot=FIRST`` on the plain route shifts by each channel's first
    element: the bits of the explicit pivot tensor, and JAX's batch
    statistics (the tolerances of ``test_plain_stats_match_jax``)."""
    x, gamma, beta = _data(shape, seed=11, axis=axis)
    xt = torch.from_numpy(x)
    first = xt[tuple(slice(None) if i == axis else 0
                     for i in range(x.ndim))].contiguous()
    m, v = bs.bn_stats(xt, bs.FIRST, axis)
    m1, v1 = bs.bn_stats(xt, first, axis)
    assert torch.equal(m, m1) and torch.equal(v, v1)
    (_, bmean, bvar), _ = _jax_train(x, gamma, beta, axis, False)
    np.testing.assert_allclose(m.numpy(), np.asarray(bmean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(bvar), rtol=1e-5,
                               atol=1e-5)


def _layout_by_view(x, axis):
    """The layout rule as a view states it: the kernel's NCHW entry for a
    contiguous tensor with the channel on axis 1, its channels-last one
    where the channel axis moved last is contiguous."""
    axis %= x.dim()
    if axis == 1 and x.is_contiguous():
        return "cf"
    return "cl" if x.movedim(axis, -1).is_contiguous() else None


@pytest.mark.parametrize("case", [
    "nchw", "nhwc3", "channels_last", "strided", "permuted", "ones",
    "unit_channel", "2d", "5d_last", "5d_cl", "sliced_rows"])
def test_layout_from_strides_matches_the_view_rule(case):
    """``layout`` reads sizes and strides without building a view, and
    agrees with the rule a ``movedim`` view states."""
    base = torch.zeros(2, 3, 4, 5)
    x, axis = {
        "nchw": (base, 1),
        "nhwc3": (base, 3),
        "channels_last": (base.to(memory_format=torch.channels_last), 1),
        "strided": (base[:, :, :, ::2], 1),
        "permuted": (base.permute(0, 2, 3, 1), 1),
        "ones": (torch.zeros(1, 3, 1, 1), 1),
        "unit_channel": (torch.zeros(2, 1, 4, 4).permute(0, 2, 3, 1), 3),
        "2d": (torch.zeros(6, 7), 1),
        "5d_last": (torch.zeros(2, 3, 2, 2, 5), 4),
        "5d_cl": (torch.zeros(2, 2, 2, 2, 5).movedim(4, 1), 1),
        "sliced_rows": (torch.zeros(8, 4, 6)[::2], 2),
    }[case]
    assert bs.layout(x, axis) == _layout_by_view(x, axis)
