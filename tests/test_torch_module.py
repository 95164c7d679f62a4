"""``mx.mod.Module`` in the port against the JAX package's, on the CPU.

An MLP and a 2-stage symbolic ResNet v1 (``chip_smoke.resnet_v1_symbol``,
the same function text in both packages) at (4, 3, 32, 32) take 3 SGD
steps (lr 0.01, momentum 0.9, wd 1e-4, kvstore ``'local'``,
``rescale_grad = 1 / batch``) from the same seeded weights, carried across
with ``convert.module_params`` and ``set_params``.  The outputs of every
step, the step-1 gradients and the final parameters and auxiliary states
must agree within 1e-4 of each tensor's largest magnitude, or twice the
JAX run's own spread when the batch is reordered (the same training in
exact arithmetic), where that is larger, as ``tests/test_torch_train.py``
holds gluon training.

In the port alone: ``fit`` on ``example/image-classification/
fine-tune.py``'s synthetic data converges and ``score`` reads it;
``fixed_param_names`` stay bit-unchanged; checkpoints round-trip (and
cross between the packages); ``predict`` trims the padding; the kvstore
path equals the updater path bit for bit; ``Module(context=None)`` without
a GPU raises, naming the missing device.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import module_params
from chip_smoke import resnet_v1_symbol

OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
STEPS, TOL = 3, 1e-4


def _mlp(sym):
    data = sym.Variable("data")
    h = sym.Activation(sym.FullyConnected(data, num_hidden=32, name="fc1"),
                       act_type="relu", name="relu1")
    h = sym.BatchNorm(h, fix_gamma=False, name="bn1")
    return sym.SoftmaxOutput(sym.FullyConnected(h, num_hidden=10,
                                                name="fc2"), name="softmax")


def _resnet(sym):
    return resnet_v1_symbol(sym, [1, 1], [16, 32, 64], 10)


CASES = {"mlp": (_mlp, (4, 20)), "resnet": (_resnet, (4, 3, 32, 32))}


def _train(pkg, sym, shape, init, x, y, steps=STEPS, kvstore="local"):
    """``steps`` forward_backward + update; (outputs of each step, step-1
    gradients, final parameters and auxiliary states), numpy."""
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))])
    if pkg is jmx:
        mod.init_params(arg_params={k: jmx.nd.array(v)
                                    for k, v in init[0].items()},
                        aux_params={k: jmx.nd.array(v)
                                    for k, v in init[1].items()})
    else:
        mod.set_params(*init)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=dict(OPT))
    outs, grads = [], None
    for step in range(steps):
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                 [pkg.nd.array(y, ctx=pkg.cpu())])
        mod.forward_backward(batch)
        outs.append(mod.get_outputs()[0].asnumpy())
        if step == 0:
            grads = {k: v.asnumpy().copy()
                     for k, v in mod._exec.grad_dict.items()}
        mod.update()
    arg, aux = (module_params if pkg is mx else _jax_params)(mod)
    return outs, grads, {**arg, **aux}


def _jax_params(mod):
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _init(sym, shape, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:] or (1,))))
            .astype("float32") for n, s in zip(sym.list_arguments(),
                                                arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: (rng.rand(*s) + 0.5 if n.endswith("var")
                else rng.randn(*s) * 0.1).astype("float32")
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _rel(a, b):
    return max((float(np.abs(a[k] - b[k]).max()) /
                max(float(np.abs(b[k]).max()), 1e-30), k) for k in b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_sgd_steps_match_jax(case):
    build, shape = CASES[case]
    j, p = build(jmx.sym), build(mx.sym)
    init = _init(j, shape)
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype("float32")
    y = rng.randint(0, 10, shape[0]).astype("float32")
    perm = np.roll(np.arange(shape[0]), 1)
    ref = _train(jmx, j, shape, init, x, y)
    again = _train(jmx, j, shape, init, x[perm], y[perm])
    got = _train(mx, p, shape, init, x, y)
    pick = [("outputs", lambda r, o=None: {
                str(i): (v[np.argsort(o)] if o is not None else v)
                for i, v in enumerate(r[0])}),
            ("step-1 gradients", lambda r, o=None: r[1]),
            ("parameters", lambda r, o=None: r[2])]
    for what, f in pick:
        want = f(ref)
        assert sorted(f(got)) == sorted(want), what
        spread, _ = _rel(f(again, perm), want)
        err, where = _rel(f(got), want)
        assert err <= max(TOL, 2 * spread), (what, err, where, spread)


def test_kvstore_path_equals_updater_path():
    """``update_on_kvstore`` (push every gradient, update the store's
    copies, pull) gives the same weights as the updater on the
    executor's, bit for bit."""
    p = _mlp(mx.sym)
    init = _init(p, (4, 20))
    rng = np.random.RandomState(2)
    x = rng.randn(4, 20).astype("float32")
    y = rng.randint(0, 10, 4).astype("float32")
    a = _train(mx, p, (4, 20), init, x, y, kvstore="local")
    b = _train(mx, p, (4, 20), init, x, y, kvstore=None)
    c = _train(mx, p, (4, 20), init, x, y, kvstore=mx.kv.create("device"))
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k], err_msg=k)
        np.testing.assert_array_equal(a[2][k], c[2][k], err_msg=k)


def _finetune_data(rng, n, n_classes):
    """``example/image-classification/fine-tune.py``'s ``make_data``."""
    y = rng.randint(0, n_classes, n)
    x = rng.rand(n, 1, 8, 8).astype("float32") * 0.2
    for i, c in enumerate(y):
        x[i, 0, (c // 2) * 4:(c // 2) * 4 + 4,
          (c % 2) * 4:(c % 2) * 4 + 4] += 0.8
    return x, y.astype("float32")


def _finetune_net(sym, head="head"):
    net = sym.Convolution(sym.Variable("data"), num_filter=8,
                          kernel=(3, 3), pad=(1, 1), name="conv1")
    net = sym.Activation(sym.BatchNorm(net, name="bn1"), act_type="relu")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = sym.FullyConnected(sym.Flatten(net), name="feat", num_hidden=16)
    net = sym.FullyConnected(sym.Activation(net, act_type="relu"),
                             name=head, num_hidden=4)
    return sym.SoftmaxOutput(net, name="softmax")


def test_fit_converges_and_scores(caplog):
    mx.random.seed(0)
    np.random.seed(0)
    rng = np.random.RandomState(0)
    x, y = _finetune_data(rng, 256, 4)
    vx, vy = _finetune_data(rng, 64, 4)
    seen = []
    with mx.cpu():
        train = mx.io.NDArrayIter(x, y, batch_size=32, shuffle=True)
        val = mx.io.NDArrayIter(vx, vy, batch_size=32)
        mod = mx.mod.Module(_finetune_net(mx.sym))
        with caplog.at_level(logging.INFO):
            mod.fit(train, eval_data=val, num_epoch=6,
                    initializer=mx.init.Xavier(rnd_type="gaussian",
                                               factor_type="in",
                                               magnitude=2),
                    optimizer="sgd", optimizer_params=dict(OPT, momentum=0.9,
                                                           learning_rate=0.1),
                    eval_metric=["acc", "ce"],
                    batch_end_callback=[mx.callback.Speedometer(32, 4),
                                        lambda p: seen.append(p.nbatch)],
                    epoch_end_callback=lambda e, s, a, b: seen.append(-1))
        score = dict(mod.score(val, ["acc", "ce"]))
    assert score["accuracy"] > 0.95, score
    assert score["cross-entropy"] < 0.3, score
    assert seen[:9] == list(range(8)) + [-1]
    assert any("Validation-accuracy" in r.getMessage()
               for r in caplog.records)
    assert any("samples/sec" in r.getMessage() for r in caplog.records)


def test_fixed_params_stay_bit_unchanged():
    p = _finetune_net(mx.sym)
    rng = np.random.RandomState(3)
    x, y = _finetune_data(rng, 64, 4)
    with mx.cpu():
        mod = mx.mod.Module(p, fixed_param_names=["conv1_weight",
                                                  "conv1_bias"])
        mod.bind(data_shapes=[("data", (32, 1, 8, 8))],
                 label_shapes=[("softmax_label", (32,))])
        mod.init_params(mx.init.Xavier())
        before = {k: v.asnumpy().copy()
                  for k, v in mod.get_params()[0].items()}
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        it = mx.io.NDArrayIter(x, y, batch_size=32)
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        after = mod.get_params()[0]
    for k in ("conv1_weight", "conv1_bias"):
        np.testing.assert_array_equal(after[k].asnumpy(), before[k])
        assert k not in mod._exec.grad_dict
    assert not np.array_equal(after["feat_weight"].asnumpy(),
                              before["feat_weight"])


def test_checkpoint_round_trip_and_predict(tmp_path):
    p = _finetune_net(mx.sym)
    rng = np.random.RandomState(4)
    x, y = _finetune_data(rng, 40, 4)
    prefix = str(tmp_path / "ft")
    with mx.cpu():
        mod = mx.mod.Module(p)
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                epoch_end_callback=mx.callback.module_checkpoint(
                    mod, prefix, save_optimizer_states=True))
        it = mx.io.NDArrayIter(x, y, batch_size=16)
        want = mod.predict(it)
        assert want.shape == (40, 4)          # the last batch's pad trimmed
        back = mx.mod.Module.load(prefix, 1, load_optimizer_states=True)
        back.bind(data_shapes=it.provide_data,
                  label_shapes=it.provide_label, for_training=True)
        back.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                              "momentum": 0.9})
        np.testing.assert_array_equal(back.predict(it).asnumpy(),
                                      want.asnumpy())
        states = mod._kvstore._updater.states
        loaded = back._kvstore._updater.states
        assert sorted(states) == sorted(loaded)
        for k in states:
            np.testing.assert_array_equal(loaded[k].numpy(),
                                          states[k].numpy())
        # a later update moves the loaded states to the weights' device
        it.reset()
        back.forward_backward(next(it))
        back.update()
        sym, arg, aux = mx.model.load_checkpoint(prefix, 1)
        assert sym.tojson() == p.tojson()
        assert sorted(arg) == sorted(mod.get_params()[0])
        assert sorted(aux) == ["bn1_moving_mean", "bn1_moving_var"]


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX Module's checkpoint loads into the port and predicts the same
    within 1e-5 of the largest output, and the reverse."""
    rng = np.random.RandomState(5)
    x, y = _finetune_data(rng, 32, 4)

    def fit(pkg, prefix):
        mod = pkg.mod.Module(_finetune_net(pkg.sym), context=pkg.cpu())
        it = pkg.io.NDArrayIter(x, y, batch_size=16)
        mod.fit(it, num_epoch=1, initializer=pkg.init.Xavier(),
                optimizer_params={"learning_rate": 0.1})
        mod.save_checkpoint(prefix, 3)
        return mod.predict(pkg.io.NDArrayIter(x, y, batch_size=16)) \
            .asnumpy()

    def load(pkg, prefix):
        mod = pkg.mod.Module.load(prefix, 3, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (16, 1, 8, 8))], for_training=False)
        return mod.predict(pkg.io.NDArrayIter(x, batch_size=16)).asnumpy()

    jmx.random.seed(0)
    with mx.cpu():
        want = fit(jmx, str(tmp_path / "jax"))
        got = load(mx, str(tmp_path / "jax"))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        want = fit(mx, str(tmp_path / "port"))
    got = load(jmx, str(tmp_path / "port"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_module_without_a_gpu_raises(monkeypatch):
    """The port's ``Module(context=None)`` runs on the current context,
    the GPU; without one it raises, naming the missing device, and never
    falls back to the CPU (the JAX package's Module defaults to cpu())."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.mod.Module(_mlp(mx.sym))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.kv.create("local").init(0, mx.nd.zeros((2,)))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        mx.mod.Module(_mlp(mx.sym), context=[mx.gpu(0), mx.gpu(1)])
    with mx.cpu():
        assert mx.mod.Module(_mlp(mx.sym))._context == mx.cpu()


def test_initializers_match_jax_by_distribution():
    """Xavier, MSRAPrelu, Normal, Uniform and the dispatch by name, in both
    packages: the same dispatch and the same moments (4 standard errors
    of the variance over 40k draws)."""
    cases = [(lambda m: m.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2), 2.0 / 200),
             (lambda m: m.init.Xavier(), 3.0 / 200 / 3),
             (lambda m: m.init.MSRAPrelu(), 2.0 / 1.0625 / 200),
             (lambda m: m.init.Normal(0.05), 0.05 ** 2),
             (lambda m: m.init.Uniform(0.1), 0.01 / 3)]
    for make, var in cases:
        for pkg in (jmx, mx):
            w = pkg.nd.zeros((200, 200), ctx=pkg.cpu())
            make(pkg)(pkg.init.InitDesc("fc_weight"), w)
            v = w.asnumpy().astype("float64")
            assert abs(v.mean()) < 4 * np.sqrt(var / v.size)
            assert abs(v.var() - var) < 4 * var * np.sqrt(2.0 / v.size), \
                (pkg.__name__, make(pkg), v.var(), var)
    for name, want in [("bn_gamma", 1.0), ("bn_beta", 0.0),
                       ("bn_moving_mean", 0.0), ("bn_moving_var", 1.0),
                       ("fc_bias", 0.0)]:
        for pkg in (jmx, mx):
            a = pkg.nd.full((3,), 7.0, ctx=pkg.cpu())
            pkg.init.Xavier()(pkg.init.InitDesc(name), a)
            np.testing.assert_array_equal(a.asnumpy(), want)
    for name, shape in [("upsampling0_weight", (2, 1, 4, 4)),
                        ("stn_loc_bias", (6,)), ("stn_loc_weight", (6, 3))]:
        got, want = mx.nd.ones(shape, ctx=mx.cpu()), jmx.nd.ones(shape)
        mx.init.Xavier()(mx.init.InitDesc(name), got)
        jmx.init.Xavier()(jmx.init.InitDesc(name), want)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)
    desc = mx.init.InitDesc("w", {"__init__": mx.init.Constant(2.5).dumps()})
    a = mx.nd.zeros((2, 2), ctx=mx.cpu())
    mx.init.Uniform()(desc, a)
    np.testing.assert_array_equal(a.asnumpy(), 2.5)
    assert mx.init.create("zeros") == mx.init.Zero()
    assert jmx.init.create(mx.init.Xavier(magnitude=2).dumps()) == \
        jmx.init.Xavier(magnitude=2)
