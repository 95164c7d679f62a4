"""Channel-last layouts (NWC/NHWC/NDHWC) in the port against the JAX
package, on the CPU.

The cases of ``tests/test_layout_nhwc.py``, each run in both packages on
the same numpy inputs: ``Convolution`` (plain, grouped, NWC, NDHWC) and
``Pooling`` (every type, ``"full"``, global, ``count_include_pad=False``)
against the JAX ops' NHWC outputs at ``RTOL = ATOL = 2e-5``, as that file
holds NHWC to NCHW, and their input (and weight) gradients against
``jax.vjp`` at 1e-4 of the largest magnitude; Gluon ``Conv2D`` NHWC's
weight shape and gradient; ResNet v1 and v2 NHWC logits against the JAX
NHWC nets with the weights carried through a ``.params`` file, and three
SGD steps of ResNet-18/50 v1 NHWC at batch 4 under the training tolerance
rule;
the symbolic NHWC graph (``infer_shape``, ``Module``).

Not here: ``Deconvolution`` NHWC (``tests/test_layout_nhwc.py:95``),
which waits for the transposed convolution (ROADMAP.md queue 1 item 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import nn as jops

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.ops import bn_stats as bs
from mxnet_tpu_torch.ops import nn as ops

RTOL, ATOL = 2e-5, 2e-5


def _rng():
    return np.random.RandomState(7)


def _grad_close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * max(np.abs(ref).max(), 1e-30))


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_()


@pytest.mark.parametrize("case", [
    dict(x=(2, 9, 9, 5), w=(7, 3, 3, 5), bias=True, layout="NHWC",
         kw=dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=7)),
    dict(x=(2, 8, 8, 10), w=(6, 3, 3, 5), bias=False, layout="NHWC",
         kw=dict(kernel=(3, 3), num_filter=6, num_group=2)),
    dict(x=(2, 11, 5), w=(4, 3, 5), bias=False, layout="NWC",
         kw=dict(kernel=(3,), num_filter=4, pad=(1,))),
    dict(x=(2, 5, 6, 4, 3), w=(4, 3, 2, 2, 3), bias=True, layout="NDHWC",
         kw=dict(kernel=(3, 2, 2), num_filter=4, stride=(1, 2, 1),
                 dilate=(1, 1, 2))),
    dict(x=(2, 7, 7, 8), w=(8, 1, 1, 8), bias=False, layout="NHWC",
         kw=dict(kernel=(1, 1), stride=(2, 2), num_filter=8)),
])
def test_convolution_channel_last_matches_jax(case):
    """Output (channel-last, contiguous) and the data, weight and bias
    gradients."""
    rng = _rng()
    x = rng.randn(*case["x"]).astype("float32")
    w = rng.randn(*case["w"]).astype("float32")
    b = rng.randn(case["w"][0]).astype("float32")
    kw = dict(case["kw"], layout=case["layout"])
    args = (x, w, b) if case["bias"] else (x, w)

    def f(*a):
        return jops.convolution(*a, no_bias=not case["bias"], **kw)
    ref, vjp = jax.vjp(f, *map(jnp.asarray, args))
    dy = rng.randn(*ref.shape).astype("float32")
    jgrads = vjp(jnp.asarray(dy))
    leaves = [_leaf(a) for a in args]
    nd = len(case["x"]) - 2
    out = ops.convolution(leaves[0], leaves[1],
                          leaves[2] if case["bias"] else None,
                          kw.get("stride"), kw.get("pad"), kw.get("dilate"),
                          kw.get("num_group", 1), kw["layout"])
    assert out.shape == ref.shape and out.is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               RTOL, ATOL * 10 if nd == 3 else ATOL)
    out.backward(torch.from_numpy(dy))
    for leaf, jg in zip(leaves, jgrads):
        _grad_close(leaf.grad, jg)
    # and through mx.nd, as test_layout_nhwc.py calls it
    got = mx.nd.Convolution(*[mx.nd.array(a, ctx=mx.cpu()) for a in args],
                            no_bias=not case["bias"], **kw)
    np.testing.assert_allclose(got.asnumpy(), np.asarray(ref), RTOL,
                               ATOL * 10 if nd == 3 else ATOL)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full"),
    dict(kernel=(3, 2), stride=(2, 2), pool_type="sum",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full", count_include_pad=False),
    dict(kernel=(5, 5), stride=(1, 1), pad=(3, 3), pool_type="max"),
    dict(global_pool=True, pool_type="avg", kernel=(1, 1)),
    dict(global_pool=True, pool_type="max", kernel=(1, 1)),
    dict(global_pool=True, pool_type="sum", kernel=(1, 1)),
])
def test_pooling_nhwc_matches_jax(kw):
    """NHWC output (contiguous) and input gradient; the same through
    ``mx.nd.Pooling``."""
    rng = _rng()
    x = rng.randn(2, 9, 8, 5).astype("float32")
    ref, vjp = jax.vjp(lambda a: jops.pooling(a, layout="NHWC", **kw),
                       jnp.asarray(x))
    dy = rng.randn(*ref.shape).astype("float32")
    leaf = _leaf(x)
    out = ops.pooling(leaf, kw.get("kernel"), kw["pool_type"],
                      kw.get("global_pool", False),
                      kw.get("pooling_convention", "valid"), kw.get("stride"),
                      kw.get("pad"), kw.get("count_include_pad", True),
                      layout="NHWC")
    assert out.shape == ref.shape and out.is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), RTOL,
                               ATOL)
    out.backward(torch.from_numpy(dy))
    _grad_close(leaf.grad, vjp(jnp.asarray(dy))[0])
    got = mx.nd.Pooling(mx.nd.array(x, ctx=mx.cpu()), layout="NHWC", **kw)
    np.testing.assert_allclose(got.asnumpy(), np.asarray(ref), RTOL, ATOL)


def test_layouts_left_for_later_raise():
    """1-D and 3-D pooling wait for ROADMAP queue 1 item 6; a layout whose
    channel is neither second nor last is refused."""
    with pytest.raises(NotImplementedError, match="item 6"):
        ops.pooling(torch.zeros(2, 5, 3), (2,), layout="NWC")
    with pytest.raises(ValueError, match="layout"):
        ops.convolution(torch.zeros(2, 5, 5, 3), torch.zeros(4, 5, 3, 3),
                        layout="NHCW")


def test_gluon_conv2d_nhwc_weight_shape_and_gradient():
    """``Conv2D(layout="NHWC")``: the deferred weight takes ``(O, kh, kw,
    I)``, the output is NHWC, and the output and weight gradient equal the
    JAX layer's with the weights carried through a ``.params`` file."""
    import tempfile
    rng = _rng()
    x = rng.randn(2, 6, 6, 5).astype("float32")
    jnet = jgluon.nn.Conv2D(8, 3, padding=1, layout="NHWC")
    jnet.initialize()
    net = gluon.nn.Conv2D(8, 3, padding=1, layout="NHWC", device="cpu")
    net.initialize()
    y = net(torch.from_numpy(x))
    assert y.shape == (2, 6, 6, 8) and net.weight.shape == (8, 3, 3, 5)
    jx = jmx.nd.array(x)
    jnet(jx)
    with tempfile.TemporaryDirectory() as d:
        jnet.save_parameters(f"{d}/c.params")
        net.load_parameters(f"{d}/c.params")
    with jag.record():
        jy = jnet(jx)
        jloss = (jy * jy).sum()
    jloss.backward()
    with ag.record():
        ty = net(torch.from_numpy(x))
        loss = (ty * ty).sum()
    ag.backward(loss)
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), RTOL,
                               ATOL * 5)
    _grad_close(net.weight.grad, jnet.weight.grad().asnumpy())


def test_gluon_conv1d_conv3d_and_pools_take_layouts():
    """Conv1D NWC and Conv3D NDHWC defer the channel-last weight;
    ``MaxPool2D``/``AvgPool2D``/``GlobalAvgPool2D`` NHWC pool NHWC data; a layout a layer does not know raises."""
    c1 = gluon.nn.Conv1D(4, 3, layout="NWC", device="cpu")
    c1.initialize()
    assert c1(torch.zeros(2, 9, 5)).shape == (2, 7, 4)
    assert c1.weight.shape == (4, 3, 5)
    c3 = gluon.nn.Conv3D(4, 2, layout="NDHWC", device="cpu")
    c3.initialize()
    assert c3(torch.zeros(1, 3, 4, 5, 6)).shape == (1, 2, 3, 4, 4)
    assert c3.weight.shape == (4, 2, 2, 2, 6)
    x = torch.from_numpy(_rng().randn(2, 8, 8, 3).astype("float32"))
    ref = x.permute(0, 3, 1, 2)
    for pool, args in ((gluon.nn.MaxPool2D, (3, 2, 1)),
                       (gluon.nn.AvgPool2D, (2,)),
                       (gluon.nn.GlobalAvgPool2D, ())):
        got = pool(*args, layout="NHWC")(x)
        want = pool(*args)(ref).permute(0, 2, 3, 1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        gluon.nn.Conv2D(4, 3, layout="NCW")
    with pytest.raises(ValueError, match="layout"):
        gluon.nn.MaxPool2D(layout="NDHWC")


# ----------------------------------------------------------------- ResNets
def _seeded(name, shape, rng):
    """BN statistics with variance > 0, He-scaled weights, gammas under
    one (as ``tests/test_torch_train.py`` seeds a net)."""
    if name.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if name.endswith(("running_mean", "beta", "bias")):
        return rng.normal(0, 0.1, shape)
    if name.endswith("gamma"):
        return rng.uniform(0.2, 0.6, shape)
    return rng.normal(0, np.sqrt(2.0 / int(np.prod(shape[1:]))), shape)


def _jax_net(name, x, path):
    jnet = jvision.get_model(name, classes=10, layout="NHWC")
    jnet.initialize()
    jnet(jmx.nd.array(x))
    seeds = np.random.RandomState(1)
    for pname, p in sorted(jnet._collect_params_with_prefix().items()):
        p.set_data(jmx.nd.array(_seeded(pname, p.shape, seeds)
                                .astype("float32")))
    jnet.save_parameters(path)
    return jnet


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1",
                                  "resnet18_v2"])
def test_resnet_nhwc_logits_match_jax(name, tmp_path):
    """Inference logits of the NHWC net at (2, 64, 64, 3) from the JAX
    NHWC net's ``.params`` file, loaded as it is (both packages store the
    weight OHWI): within 1e-4 of the largest logit; the same weights
    transposed into the port's NCHW net give the same logits."""
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype("float32")
    path = str(tmp_path / "w.params")
    jnet = _jax_net(name, x, path)
    ref = jnet(jmx.nd.array(x)).asnumpy()
    net = get_model(name, classes=10, layout="NHWC", device="cpu")
    net.load_parameters(path)
    stem = net.features[1 if name.endswith("v2") else 0]
    assert stem.weight.shape == (64, 7, 7, 3)
    got = net(torch.from_numpy(x)).detach().numpy()
    tol = 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    nchw = get_model(name, classes=10, device="cpu")
    nchw(torch.zeros(1, 3, 64, 64))        # fixes the deferred shapes
    nchw.load_state_dict({k: v.permute(0, 3, 1, 2) if v.dim() == 4 else v
                          for k, v in net.state_dict().items()})
    out = nchw(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=tol)


OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
STEPS = 3


def _train_jax(name, path, x, y, perm):
    net = jvision.get_model(name, classes=10, layout="NHWC")
    net.load_parameters(path)
    trainer = jgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    params = net._collect_params_with_prefix()
    losses, grads = [], None
    for step in range(STEPS):
        with jag.record():
            loss = loss_fn(net(jmx.nd.array(x[perm])), jmx.nd.array(y[perm]))
        loss.backward()
        losses.append(loss.asnumpy()[np.argsort(perm)])
        if step == 0:
            grads = {k: p.grad().asnumpy() for k, p in params.items()
                     if p.grad_req != "null"}
        trainer.step(len(x))
    return losses, grads, {k: p.data().asnumpy() for k, p in params.items()}


def _train_port(name, path, x, y):
    net = get_model(name, classes=10, layout="NHWC", device="cpu")
    net.load_parameters(path)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = net.collect_params()
    losses, grads = [], None
    copies = bs.bn_stats.copies
    for step in range(STEPS):
        with ag.record():
            loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
        ag.backward(loss)
        losses.append(loss.detach().numpy())
        if step == 0:
            grads = {k: p.grad().clone().numpy() for k, p in params.items()
                     if p.grad_req != "null"}
        trainer.step(len(x))
    assert bs.bn_stats.copies == copies
    return losses, grads, {k: p.data().detach().numpy()
                           for k, p in params.items()}


def _rel(a, b):
    keys = sorted(b)
    assert sorted(a) == keys and keys
    return max(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)
               for k in keys)


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1"])
def test_resnet_nhwc_training_steps_match_jax(name, tmp_path):
    """Three SGD steps (lr 0.01, momentum 0.9, wd 1e-4) of the NHWC net at
    (4, 64, 64, 3) from the JAX net's ``.params`` file: the step-1
    gradients, the per-step losses and every parameter and running
    statistic after step 3, each within 1e-4 of its max or twice the JAX
    package's own spread when the batch is reordered (two other orders),
    if that is larger: the rule and the batch of
    ``tests/test_torch_train.py``, whose docstring says why ResNet-50
    needs it (at batch 2 a single reordering measures too little of its
    spread); no BatchNorm input is copied."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 64, 64, 3).astype("float32")
    y = rng.randint(0, 10, 4).astype("float32")
    path = str(tmp_path / "w.params")
    _jax_net(name, x, path)
    ref = _train_jax(name, path, x, y, np.arange(4))
    others = [_train_jax(name, path, x, y, np.array(p))
              for p in ([2, 0, 3, 1], [1, 3, 0, 2])]
    port = _train_port(name, path, x, y)

    def check(what, pick):
        spread = max(_rel(pick(o), pick(ref)) for o in others)
        tol = max(1e-4, 2 * spread)
        err = _rel(pick(port), pick(ref))
        assert err <= tol, f"{name} {what}: {err:.3g} > {tol:.3g}"

    for step in range(STEPS):
        assert np.isfinite(port[0][step]).all()
        check(f"loss of step {step + 1}", lambda r: {"l": r[0][step]})
    check("step-1 gradients", lambda r: r[1])
    check("parameters and running statistics after step 3", lambda r: r[2])


# ---------------------------------------------------------------- symbol
def _sym(pkg, hinted=False):
    """A small NHWC graph.  ``hinted`` declares the convolution weights'
    shapes on their variables: the JAX package's ``infer_shape`` gives an
    NHWC convolution the channel-first weight ``(O, C, kh, kw)``, which
    its own op then refuses, so its Module binds this graph only so."""
    def weight(name, shape):
        return pkg.sym.Variable(name, shape=shape) if hinted else None

    d = pkg.sym.Variable("data")
    w0 = weight("conv0_weight", (8, 3, 3, 3))
    h = pkg.sym.Convolution(d, *([w0] if hinted else []), kernel=(3, 3),
                            num_filter=8, pad=(1, 1), layout="NHWC",
                            no_bias=True, name="conv0")
    h = pkg.sym.BatchNorm(h, axis=3, fix_gamma=False, name="bn0")
    h = pkg.sym.Activation(h, act_type="relu", name="relu0")
    h = pkg.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                        layout="NHWC", name="pool0")
    w1 = weight("conv1_weight", (6, 1, 1, 8))
    h = pkg.sym.Convolution(h, *([w1] if hinted else []), kernel=(1, 1),
                            num_filter=6, layout="NHWC", name="conv1")
    h = pkg.sym.Pooling(h, global_pool=True, pool_type="avg", kernel=(1, 1),
                        layout="NHWC", name="gap")
    h = pkg.sym.FullyConnected(h, num_hidden=4, name="fc")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def test_symbol_nhwc_infer_shape_and_module_match_jax():
    """``infer_shape`` gives the NHWC weights ``(num_filter, kh, kw, C)``
    and the statistics ``(C,)`` unprompted (the shapes the JAX package
    reaches with the weights declared); a ``Module`` bound on the NHWC
    graph takes two SGD steps from the JAX Module's parameters and matches
    its outputs and parameters within 1e-5 of each tensor's max."""
    shape = (4, 8, 8, 3)
    jargs, jouts, jaux = _sym(jmx, True).infer_shape(data=shape)
    targs, touts, taux = _sym(mx).infer_shape(data=shape)
    assert targs == jargs and touts == jouts and taux == jaux
    assert _sym(mx, True).infer_shape(data=shape) == (targs, touts, taux)
    names = _sym(mx).list_arguments()
    assert dict(zip(names, targs))["conv0_weight"] == (8, 3, 3, 3)
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype("float32")
    y = rng.randint(0, 4, 4).astype("float32")

    def run(pkg):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(_sym(pkg, True), context=ctx)
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        init = np.random.RandomState(4)
        args, auxs = mod.get_params()
        mod.set_params(
            {k: pkg.nd.array(init.randn(*v.shape).astype("float32") * 0.3,
                             ctx=ctx) for k, v in sorted(args.items())},
            {k: pkg.nd.array(np.ones(v.shape, "float32"), ctx=ctx)
             for k, v in auxs.items()})
        mod.init_optimizer(kvstore="local", optimizer="sgd",
                           optimizer_params=dict(learning_rate=0.1))
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)])
        outs = []
        for _ in range(2):
            mod.forward_backward(batch)
            outs.append(mod.get_outputs()[0].asnumpy())
            mod.update()
        args, auxs = mod.get_params()
        return outs, {k: v.asnumpy() for k, v in {**args, **auxs}.items()}, \
            mod

    (jouts_, jp, jmod), (touts_, tp, _) = run(jmx), run(mx)
    for a, b in zip(touts_, jouts_):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0,
                                   atol=1e-5 * np.abs(jp[k]).max())
    # the JAX Module's NHWC parameters cross through convert.module_params
    from mxnet_tpu_torch.convert import module_params
    jarg, jaux = module_params(jmod)
    mod = mx.mod.Module(_sym(mx), context=mx.cpu())
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (4,))], for_training=False)
    mod.set_params({k: mx.nd.array(v, ctx=mx.cpu()) for k, v in jarg.items()},
                   {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in jaux.items()})
    mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())], None),
                is_train=False)
    jmod.forward(jmx.io.DataBatch([jmx.nd.array(x)], None), is_train=False)
    want = jmod.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
