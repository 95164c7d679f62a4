"""The transposed convolution and 1-D/3-D pooling of the port against the
JAX package, on the CPU.

``Deconvolution`` (1-, 2- and 3-D; stride, pad, ``adj``, dilation, groups
and a bias; NCW/NCHW/NCDHW and NWC/NHWC/NDHWC) and windowed and global
``Pooling`` over 1-D and 3-D data (max, avg, sum and lp; ``valid`` and
``full``; ``count_include_pad=False``) take the same numpy inputs in both
packages: outputs within ``RTOL = ATOL = 2e-5`` of ``mxnet_tpu.ops.nn``'s,
input and weight gradients within 1e-4 of the largest magnitude of
``jax.vjp``'s.  ``Conv1DTranspose``/``Conv2DTranspose``/``Conv3DTranspose``
are held against the JAX layers with the weights carried through a
``.params`` file, and the seven 1-D and 3-D pooling layers against the JAX
ones.  ``target_shape`` raises, and a symbolic ``Deconvolution`` infers
its weight's shape and binds through ``simple_bind`` and ``Module``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import nn as jops

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import nn as ops

RTOL, ATOL = 2e-5, 2e-5


def _rng():
    return np.random.RandomState(11)


def _grad_close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=1e-4 * max(np.abs(ref).max(), 1e-30))


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_()


def _jax_vjp(f, args, rng):
    """``f(*args)`` and its gradients against a seeded head gradient,
    through one jitted program (cheaper to compile than op by op):
    (output, head gradient, input gradients)."""
    dy = rng.randn(*jax.eval_shape(f, *args).shape).astype("float32")

    def fwd_bwd(head, *a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(head)
    out, grads = jax.jit(fwd_bwd)(dy, *args)
    return np.asarray(out), dy, grads


def _weight_shape(cin, nf, groups, kernel, channel_last):
    return (cin,) + kernel + (nf // groups,) if channel_last else \
        (cin, nf // groups) + kernel


# ----------------------------------------------------------- the op
DECONV_CASES = [
    dict(x=(2, 4, 7), kw=dict(kernel=(3,), stride=(2,), pad=(1,), adj=(1,),
                              num_filter=5), bias=True),
    dict(x=(2, 4, 5, 5), kw=dict(kernel=(3, 3), num_filter=6), bias=False),
    dict(x=(2, 4, 5, 6), kw=dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                 adj=(1, 0), num_filter=6), bias=True),
    dict(x=(2, 4, 5, 5), kw=dict(kernel=(3, 2), dilate=(2, 1), pad=(1, 0),
                                 num_filter=3), bias=False),
    dict(x=(2, 4, 6, 5), kw=dict(kernel=(3, 3), stride=(2, 1), pad=(1, 1),
                                 num_filter=6, num_group=2), bias=True),
    dict(x=(2, 6, 6, 4), layout="NHWC",
         kw=dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
                 num_filter=6, num_group=2), bias=True),
    dict(x=(2, 7, 4), layout="NWC",
         kw=dict(kernel=(4,), stride=(3,), dilate=(2,), num_filter=3),
         bias=False),
    dict(x=(2, 3, 4, 3, 5), kw=dict(kernel=(3, 2, 3), stride=(2, 1, 2),
                                    pad=(1, 0, 1), adj=(1, 0, 0),
                                    num_filter=4), bias=True),
    dict(x=(2, 3, 4, 3, 4), layout="NDHWC",
         kw=dict(kernel=(2, 3, 2), stride=(1, 2, 2), dilate=(1, 1, 2),
                 num_filter=4, num_group=2), bias=True),
]


@pytest.mark.parametrize("case", DECONV_CASES)
def test_deconvolution_matches_jax(case):
    """Output (contiguous in the caller's layout), and the data, weight
    and bias gradients against ``jax.vjp``; the same through
    ``mx.nd.Deconvolution``."""
    rng = _rng()
    kw = dict(case["kw"], layout=case.get("layout"))
    channel_last = case.get("layout") is not None   # NWC, NHWC, NDHWC
    cin = case["x"][-1 if channel_last else 1]
    x = rng.randn(*case["x"]).astype("float32")
    w = rng.randn(*_weight_shape(cin, kw["num_filter"],
                                 kw.get("num_group", 1), kw["kernel"],
                                 channel_last)).astype("float32")
    b = rng.randn(kw["num_filter"]).astype("float32")
    args = (x, w, b) if case["bias"] else (x, w)

    def f(*a):
        return jops.deconvolution(*a, no_bias=not case["bias"], **kw)
    ref, dy, jgrads = _jax_vjp(f, args, rng)
    leaves = [_leaf(a) for a in args]
    out = ops.deconvolution(leaves[0], leaves[1],
                            leaves[2] if case["bias"] else None,
                            kw.get("stride"), kw.get("pad"),
                            kw.get("dilate"), kw.get("adj"),
                            kw.get("num_group", 1), kw["layout"])
    assert out.shape == ref.shape and out.is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), RTOL,
                               ATOL)
    out.backward(torch.from_numpy(dy))
    for leaf, jg in zip(leaves, jgrads):
        _grad_close(leaf.grad.numpy(), jg)
    got = mx.nd.Deconvolution(*[mx.nd.array(a, ctx=mx.cpu()) for a in args],
                              no_bias=not case["bias"], **kw)
    np.testing.assert_allclose(got.asnumpy(), np.asarray(ref), RTOL, ATOL)


def test_deconvolution_no_bias_by_default_and_target_shape_raises():
    """``no_bias`` defaults to True: a bias given without ``no_bias=False``
    is not added, as in the JAX op; a nonzero ``target_shape`` (which
    MXNet derives pad and adj from) is not ported and raises."""
    rng = _rng()
    x, w, b = (rng.randn(*s).astype("float32")
               for s in ((1, 2, 4, 4), (2, 3, 3, 3), (3,)))
    kw = dict(kernel=(3, 3), num_filter=3)
    ref = jmx.nd.Deconvolution(*map(jmx.nd.array, (x, w, b)), **kw)
    got = mx.nd.Deconvolution(*(mx.nd.array(a, ctx=mx.cpu())
                                for a in (x, w, b)), **kw)
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), RTOL, ATOL)
    np.testing.assert_allclose(
        got.asnumpy(), mx.nd.Deconvolution(
            mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(w, ctx=mx.cpu()),
            **kw).asnumpy(), 0, 0)
    with pytest.raises(NotImplementedError, match="target_shape"):
        mx.nd.Deconvolution(mx.nd.array(x, ctx=mx.cpu()),
                            mx.nd.array(w, ctx=mx.cpu()),
                            target_shape=(6, 6), **kw)
    # all zeros is MXNet's "not given"
    zeros = mx.nd.Deconvolution(mx.nd.array(x, ctx=mx.cpu()),
                                mx.nd.array(w, ctx=mx.cpu()),
                                target_shape=(0, 0), **kw)
    np.testing.assert_array_equal(zeros.asnumpy(), got.asnumpy())


def _pool_cases(nd):
    k, s, p = (3,) * nd, (2,) * nd, (1,) * nd
    return [dict(kernel=k, stride=s, pad=p, pool_type="max"),
            dict(kernel=k, stride=s, pool_type="max",
                 pooling_convention="full"),
            dict(kernel=k, stride=s, pad=p, pool_type="avg"),
            dict(kernel=k, stride=s, pad=p, pool_type="avg",
                 pooling_convention="full"),
            dict(kernel=k, stride=s, pad=p, pool_type="avg",
                 count_include_pad=False),
            dict(kernel=k, stride=s, pad=p, pool_type="avg",
                 pooling_convention="full", count_include_pad=False),
            dict(kernel=(2,) * nd, stride=(1,) * nd, pool_type="sum",
                 pooling_convention="full"),
            dict(kernel=(2,) * nd, stride=s, pool_type="lp", p_value=2),
            dict(global_pool=True, pool_type="max", kernel=(1,) * nd),
            dict(global_pool=True, pool_type="avg", kernel=(1,) * nd),
            dict(global_pool=True, pool_type="sum", kernel=(1,) * nd)]


# every case channel-first; channel-last takes the same code after its
# transpose, so four of them: max, avg full without padding, sum, global
POOL_RUNS = [(lay, c) for lay in ("NCW", "NCDHW") for c in range(11)] + \
    [(lay, c) for lay in ("NWC", "NDHWC") for c in (0, 5, 6, 9)]


@pytest.mark.parametrize("layout, case", POOL_RUNS)
def test_pooling_1d_3d_matches_jax(layout, case):
    """Output (contiguous in the caller's layout) and input gradient
    against ``jax.vjp``; the same through ``mx.nd.Pooling``; lp through
    the op only, as the port's ``ops.nn.pooling`` takes max, avg and
    sum."""
    nd = len(layout) - 2
    kw = dict(_pool_cases(nd)[case], layout=layout)
    shape = (2, 3, 9) if nd == 1 else (2, 3, 7, 6, 5)
    if layout[-1] == "C":
        shape = (shape[0],) + shape[2:] + (shape[1],)
    rng = _rng()
    x = rng.randn(*shape).astype("float32")
    ref, dy, (jgrad,) = _jax_vjp(lambda a: jops.pooling(a, **kw), (x,), rng)
    got = mx.nd.Pooling(mx.nd.array(x, ctx=mx.cpu()), **kw)
    np.testing.assert_allclose(got.asnumpy(), ref, RTOL, ATOL)
    if kw["pool_type"] == "lp":
        return
    leaf = _leaf(x)
    out = ops.pooling(leaf, kw["kernel"], kw["pool_type"],
                      kw.get("global_pool", False),
                      kw.get("pooling_convention", "valid"), kw.get("stride"),
                      kw.get("pad"), kw.get("count_include_pad", True),
                      layout)
    assert out.shape == ref.shape and out.is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), RTOL,
                               ATOL)
    out.backward(torch.from_numpy(dy))
    _grad_close(leaf.grad.numpy(), jgrad)


def test_pooling_refuses_other_ranks_and_layouts():
    with pytest.raises(ValueError, match="1-, 2- or 3-D"):
        ops.pooling(torch.zeros(2, 3), (2,))
    with pytest.raises(ValueError, match="layout"):
        ops.pooling(torch.zeros(2, 5, 3, 4, 6), (2, 2, 2), layout="NDCHW")
    with pytest.raises(ValueError, match="layout"):
        ops.deconvolution(torch.zeros(2, 5, 3), torch.zeros(5, 2, 3),
                          layout="WNC")


# --------------------------------------------------------- the layers
TRANSPOSE_LAYERS = [
    ("Conv1DTranspose", (5, 3), dict(strides=2, padding=1, output_padding=1),
     (2, 4, 6)),
    ("Conv1DTranspose", (4, 3), dict(layout="NWC", activation="relu"),
     (2, 6, 3)),
    ("Conv2DTranspose", (6, 3), dict(strides=2, padding=1, output_padding=1,
                                     groups=2), (2, 4, 5, 5)),
    ("Conv2DTranspose", (4, (3, 2)), dict(strides=(2, 1), dilation=(1, 2),
                                          use_bias=False, layout="NHWC"),
     (2, 5, 4, 3)),
    ("Conv3DTranspose", (4, 2), dict(strides=2, output_padding=(1, 0, 1)),
     (1, 3, 3, 4, 3)),
    ("Conv3DTranspose", (2, 3), dict(padding=1, layout="NDHWC"),
     (1, 3, 4, 3, 4)),
]


@pytest.mark.parametrize("layer", TRANSPOSE_LAYERS,
                         ids=lambda c: f"{c[0]}-{c[2].get('layout', 'NC')}")
def test_transposed_conv_layers_match_jax(layer, tmp_path):
    """A deferred ``in_channels`` takes the JAX layer's weight shape; the
    JAX layer's ``.params`` file loads; output and weight (and bias)
    gradients of ``sum(y * y)`` agree."""
    name, args, kw, shape = layer
    x = _rng().randn(*shape).astype("float32")
    jlayer = getattr(jnn, name)(*args, **kw)
    jlayer.initialize(jmx.init.Normal(0.5))
    jx = jmx.nd.array(x)
    jlayer(jx)
    jlayer.save_parameters(str(tmp_path / "t.params"))
    port = getattr(nn, name)(*args, **kw, device="cpu")
    port.load_parameters(str(tmp_path / "t.params"))
    assert tuple(port.weight.shape) == tuple(jlayer.weight.shape)
    with jag.record():
        jy = jlayer(jx)
        jloss = (jy * jy).sum()
    jloss.backward()
    with ag.record():
        y = port(torch.from_numpy(x))
        loss = (y * y).sum()
    ag.backward(loss)
    assert tuple(y.shape) == jy.shape
    np.testing.assert_allclose(y.detach().numpy(), jy.asnumpy(), RTOL, ATOL)
    _grad_close(port.weight.tensor().grad.numpy(),
                jlayer.weight.grad().asnumpy())
    if kw.get("use_bias", True):
        _grad_close(port.bias.tensor().grad.numpy(),
                    jlayer.bias.grad().asnumpy())
    # deferred in_channels, filled by the first forward
    fresh = getattr(nn, name)(*args, **kw, device="cpu")
    fresh.initialize()
    fresh(torch.from_numpy(x))
    assert tuple(fresh.weight.shape) == tuple(jlayer.weight.shape)


POOL_LAYERS = [
    ("MaxPool1D", (3, 2, 1), {}, (2, 3, 9)),
    ("MaxPool1D", (2,), dict(layout="NWC", ceil_mode=True), (2, 7, 3)),
    ("MaxPool3D", (2, 2, 0, True), {}, (2, 3, 5, 4, 5)),
    ("MaxPool3D", (3, 1, 1), dict(layout="NDHWC"), (1, 4, 3, 5, 2)),
    ("AvgPool1D", (3, 2, 1), dict(count_include_pad=False), (2, 3, 9)),
    ("AvgPool1D", (2,), dict(layout="NWC", ceil_mode=True), (2, 7, 3)),
    ("AvgPool3D", (3, 2, 1), dict(ceil_mode=True), (2, 3, 6, 5, 4)),
    ("AvgPool3D", (2,), dict(layout="NDHWC", count_include_pad=False),
     (1, 4, 4, 5, 2)),
    ("GlobalAvgPool1D", (), {}, (2, 3, 9)),
    ("GlobalAvgPool1D", (), dict(layout="NWC"), (2, 7, 3)),
    ("GlobalAvgPool3D", (), {}, (2, 3, 4, 5, 3)),
    ("GlobalAvgPool3D", (), dict(layout="NDHWC"), (1, 4, 3, 5, 2)),
    ("GlobalMaxPool3D", (), {}, (2, 3, 4, 5, 3)),
    ("GlobalMaxPool3D", (), dict(layout="NDHWC"), (1, 4, 3, 5, 2)),
]


@pytest.mark.parametrize("layer", POOL_LAYERS,
                         ids=lambda c: f"{c[0]}-{c[2].get('layout', 'NC')}")
def test_pooling_layers_match_jax(layer):
    name, args, kw, shape = layer
    x = _rng().randn(*shape).astype("float32")
    ref = getattr(jnn, name)(*args, **kw)(jmx.nd.array(x)).asnumpy()
    out = getattr(nn, name)(*args, **kw)(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, RTOL, ATOL)


def test_layers_refuse_a_layout_of_another_rank():
    with pytest.raises(ValueError, match="layout"):
        nn.Conv2DTranspose(4, 3, layout="NCW")
    with pytest.raises(ValueError, match="layout"):
        nn.MaxPool3D(layout="NCHW")
    with pytest.raises(ValueError, match="layout"):
        nn.GlobalAvgPool1D(layout="NCDHW")


# ------------------------------------------------------- the symbolic op
def _deconv_sym(pkg):
    data = pkg.sym.var("data")
    y = pkg.sym.Deconvolution(data, kernel=(3, 3), stride=(2, 2),
                              pad=(1, 1), adj=(1, 1), num_filter=6,
                              num_group=2, name="up")
    return pkg.sym.Deconvolution(y, kernel=(2, 2), num_filter=3,
                                 no_bias=False, name="up2")


def test_symbolic_deconvolution_infers_and_binds():
    """``infer_shape`` gives ``(C, num_filter / num_group, *kernel)``
    weights (and a bias only with ``no_bias=False``) as the JAX package
    does; ``simple_bind`` and a ``Module`` run the graph, matching the JAX
    op applied to the same values."""
    shape = (2, 4, 5, 5)
    sym = _deconv_sym(mx)
    assert sym.list_arguments() == _deconv_sym(jmx).list_arguments() == [
        "data", "up_weight", "up2_weight", "up2_bias"]
    args, outs, _ = sym.infer_shape(data=shape)
    assert dict(zip(sym.list_arguments(), args)) == {
        "data": shape, "up_weight": (4, 3, 3, 3), "up2_weight": (6, 3, 2, 2),
        "up2_bias": (3,)}
    assert outs == [(2, 3, 11, 11)]
    rng = _rng()
    values = {n: rng.randn(*s).astype("float32")
              for n, s in zip(sym.list_arguments(), args)}
    h = jops.deconvolution(jnp.asarray(values["data"]),
                           jnp.asarray(values["up_weight"]), kernel=(3, 3),
                           stride=(2, 2), pad=(1, 1), adj=(1, 1),
                           num_filter=6, num_group=2)
    want = np.asarray(jops.deconvolution(
        h, jnp.asarray(values["up2_weight"]), jnp.asarray(values["up2_bias"]),
        kernel=(2, 2), num_filter=3, no_bias=False))
    ex = sym.simple_bind(ctx=mx.cpu(), data=shape)
    for n, v in values.items():
        ex.arg_dict[n][:] = mx.nd.array(v, ctx=mx.cpu())
    got = ex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, want, RTOL, ATOL * 10)
    mod = mx.mod.Module(sym, data_names=["data"], label_names=None,
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", shape)], for_training=False)
    mod.init_params()
    mod.set_params({n: mx.nd.array(v, ctx=mx.cpu())
                    for n, v in values.items() if n != "data"}, {})
    mod.forward(mx.io.DataBatch([mx.nd.array(values["data"], ctx=mx.cpu())],
                                None), is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want, RTOL,
                               ATOL * 10)
