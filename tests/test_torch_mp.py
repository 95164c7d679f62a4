"""Multi-precision training in the port against the JAX package, on the CPU:
the ``mp_sgd_*`` operators, ``SGD(multi_precision=True)`` on fp16
weights, the grouped multi-precision update, ``all_finite`` /
``multi_all_finite``, ``Block.cast``/``Parameter.cast``, the Trainer's
``save_states``/``load_states``, and carrying bf16 and fp16 weights across
with ``convert``.  Tolerances are stated per test.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import convert, gluon, optimizer
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.ops import optimizer_ops


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x.asnumpy()).astype(np.float32)


_MP_KW = [dict(lr=0.1), dict(lr=0.05, wd=0.01, rescale_grad=0.5),
          dict(lr=0.1, wd=1e-3, clip_gradient=0.2, momentum=0.9)]


@pytest.mark.parametrize("mom", [False, True])
@pytest.mark.parametrize("kw", _MP_KW)
def test_mp_sgd_operators_match_jax(kw, mom):
    """Three ``mp_sgd_update`` / ``mp_sgd_mom_update`` calls through
    ``mx.nd`` in both packages on an fp16 weight with its fp32 master:
    every output written in place (weight, master, momentum), the fp32
    ones within 1e-6, the fp16 weight bit for bit."""
    kw = dict(kw)
    momentum = kw.pop("momentum", 0.9 if mom else None)
    rng = np.random.RandomState(0)
    w32 = rng.randn(5, 7).astype("float32")
    grads = [rng.randn(5, 7).astype("float16") for _ in range(3)]
    runs = []
    for mx_, ctx in ((jmx, {}), (pmx, {"ctx": pmx.cpu()})):
        w = mx_.nd.array(w32, **ctx).astype("float16")
        master = mx_.nd.array(w32, **ctx)
        m = mx_.nd.zeros((5, 7), **ctx)
        for g in grads:
            gg = mx_.nd.array(g, dtype="float16", **ctx)
            if mom:
                mx_.nd.mp_sgd_mom_update(w, gg, m, master, out=w,
                                         momentum=momentum, **kw)
            else:
                mx_.nd.mp_sgd_update(w, gg, master, out=w, **kw)
        runs.append((w, master, m))
    (jw, jm32, jm), (pw, pm32, pm) = runs
    assert str(pw.dtype) == "float16" and str(pm32.dtype) == "float32"
    np.testing.assert_array_equal(_np(pw), _np(jw))
    np.testing.assert_allclose(_np(pm32), _np(jm32), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(pm), _np(jm), rtol=0, atol=1e-6)
    assert not np.allclose(_np(pm32), w32)


def test_multi_precision_sgd_on_fp16():
    """``tests/test_optimizer.py:85``'s case in the port, beside the JAX
    optimizer: the state holds an fp32 master, the weight stays fp16 and
    moves, and equals the JAX package's bit for bit after two updates."""
    rng = np.random.RandomState(1)
    w0 = rng.rand(4).astype(np.float16)
    g = rng.rand(4).astype(np.float16)
    o = optimizer.SGD(learning_rate=0.1, momentum=0.9, multi_precision=True)
    weight = torch.from_numpy(w0.copy())
    state = o.create_state_multi_precision(0, weight)
    assert state[0].dtype == torch.float32 and state[1].dtype == \
        torch.float32
    jo = jopt.SGD(learning_rate=0.1, momentum=0.9, multi_precision=True)
    jw = jmx.nd.array(w0, dtype=np.float16)
    jstate = jo.create_state_multi_precision(0, jw)
    for _ in range(2):
        o.update_multi_precision(0, weight, torch.from_numpy(g), state)
        jo.update_multi_precision(0, jw, jmx.nd.array(g, dtype=np.float16),
                                  jstate)
    assert weight.dtype == torch.float16
    assert not np.allclose(weight.numpy(), w0)
    np.testing.assert_array_equal(weight.numpy(), jw.asnumpy())
    np.testing.assert_allclose(state[0].numpy(), jstate[0].asnumpy(),
                               rtol=0, atol=1e-7)


def test_bare_fp16_warns_and_fp32_has_no_master():
    o = optimizer.SGD(learning_rate=0.1, momentum=0.9)
    with pytest.warns(UserWarning, match="multi_precision=True"):
        state = o.create_state_multi_precision(0, torch.ones(3).half())
    assert isinstance(state, torch.Tensor) and state.dtype == torch.float16
    o = optimizer.SGD(learning_rate=0.1, multi_precision=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert o.create_state_multi_precision(0, torch.ones(3)) is None


def _updater_run(opt_name, kw, aggregate, steps=3):
    rng = np.random.RandomState(2)
    shapes = [(3, 4), (5,), (2, 2, 2), (6,), (3, 4)]
    dtypes = [torch.float16, torch.float16, torch.float32, torch.float16,
              torch.float32]
    ws = [torch.from_numpy(rng.randn(*s).astype("float32")).to(d)
          for s, d in zip(shapes, dtypes)]
    o = optimizer.create(opt_name, **kw)
    o.aggregate_num = 256 if aggregate else 1
    up = optimizer.get_updater(o)
    for _ in range(steps):
        gs = [torch.from_numpy(rng.randn(*w.shape).astype("float32"))
              .to(w.dtype) for w in ws]
        up(list(range(len(ws))), gs, ws)
    return ws, up.states


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                 multi_precision=True)),
    ("sgd", dict(learning_rate=0.1, multi_precision=True,
                 clip_gradient=0.5)),
    ("adam", dict(learning_rate=0.01, wd=1e-3, multi_precision=True)),
])
def test_grouped_multi_precision_is_bitwise_per_parameter(opt_name, kw):
    """Three updates of fp16 and fp32 weights through an ``Updater``: the
    grouped path (fp16 members in a multi-precision group on their
    masters) equals the per-parameter ``update_multi_precision`` bit for
    bit, weights and every state tensor."""
    grouped, gstates = _updater_run(opt_name, kw, True)
    single, sstates = _updater_run(opt_name, kw, False)
    for a, b in zip(grouped, single):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)

    def flat(s):
        if s is None:
            return []
        if isinstance(s, torch.Tensor):
            return [s]
        return [t for x in s for t in flat(x)]
    for k in gstates:
        for a, b in zip(flat(gstates[k]), flat(sstates[k]), strict=True):
            assert torch.equal(a, b)
    assert gstates[0][0].dtype == torch.float32           # the master


def test_multi_precision_sgd_updater_matches_jax():
    """The same fp16 weights and gradients through both packages'
    ``Updater`` (grouped): the fp16 weights bit for bit, the masters
    within 1e-6."""
    rng = np.random.RandomState(3)
    shapes = [(3, 4), (5,), (6,)]
    ws = [rng.randn(*s).astype("float16") for s in shapes]
    grads = [[rng.randn(*s).astype("float16") for s in shapes]
             for _ in range(3)]
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3, multi_precision=True)
    jup = jopt.get_updater(jopt.create("sgd", **kw))
    pup = optimizer.get_updater(optimizer.create("sgd", **kw))
    jw = [jmx.nd.array(w, dtype="float16") for w in ws]
    pw = [torch.from_numpy(w.copy()) for w in ws]
    idx = list(range(len(ws)))
    for gs in grads:
        jup(idx, [jmx.nd.array(g, dtype="float16") for g in gs], jw)
        pup(idx, [torch.from_numpy(g) for g in gs], pw)
    for a, b in zip(pw, jw):
        np.testing.assert_array_equal(a.numpy(), b.asnumpy())
    for i in idx:
        np.testing.assert_allclose(pup.states[i][0].numpy(),
                                   jup.states[i][0].asnumpy(), atol=1e-6)


_FINITE_CASES = [("finite", None), ("inf", np.inf), ("nan", np.nan),
                 ("-inf", -np.inf)]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("name,value", _FINITE_CASES,
                         ids=[c[0] for c in _FINITE_CASES])
def test_all_finite_ops_match_jax(name, value, dtype):
    """``all_finite`` and ``multi_all_finite`` over three arrays, one of
    them poisoned, in both packages: float32 (1,) outputs, equal."""
    rng = np.random.RandomState(4)
    arrays = [rng.randn(*s).astype("float32") for s in ((3, 4), (7,), (2, 5))]
    if value is not None:
        arrays[2][1, 3] = value
    out = []
    for mx_, ctx in ((jmx, {}), (pmx, {"ctx": pmx.cpu()})):
        nds = [mx_.nd.array(a, **ctx).astype(dtype) for a in arrays]
        out.append((mx_.nd.all_finite(*nds),
                    mx_.nd.multi_all_finite(*nds, num_arrays=3)))
    for j, p in zip(*out):
        assert p.shape == j.shape == (1,) and str(p.dtype) == "float32"
        np.testing.assert_array_equal(_np(p), _np(j))
    assert _np(out[1][0])[0] == (1.0 if value is None else 0.0)


def test_multi_all_finite_is_one_reduction():
    """The loss scaler's scan reads the host once: ``multi_all_finite``
    returns one device value for any number of arrays."""
    grads = [torch.randn(5) for _ in range(200)]
    grads[150][2] = float("nan")
    out = optimizer_ops.multi_all_finite(*grads)
    assert out.shape == (1,) and out.item() == 0.0
    assert optimizer_ops.multi_all_finite(*grads[:150]).item() == 1.0


# ------------------------------------------------------------------- cast
def test_block_cast_matches_jax(tmp_path):
    """``net.cast("float16")`` on ResNet-18 v1 in both packages: every
    parameter fp16 but BatchNorm's, whose parameters and running
    statistics stay fp32 (as in the JAX package and MXNet); a training
    inference forward on fp16 input gives fp16 logits within 2e-2 of the
    JAX package's (fp16 arithmetic), and a training step's gradients take
    their parameters' dtypes."""
    rng = np.random.RandomState(5)
    jnet = jvision.get_model("resnet18_v1", classes=10)
    jnet.initialize()
    x = rng.randn(2, 3, 32, 32).astype("float32")
    jnet(jmx.nd.array(x))
    path = str(tmp_path / "r18.params")
    jnet.save_parameters(path)
    pnet = get_model("resnet18_v1", classes=10, device="cpu")
    pnet.load_parameters(path)
    jnet.cast("float16")
    pnet.cast("float16")
    jd = {k: str(p.data().dtype)
          for k, p in jnet._collect_params_with_prefix().items()}
    pd = {k: str(t.dtype)[6:]
          for k, t in pnet._collect_params_with_prefix().items()}
    assert pd == jd
    assert {pd[k] for k in pd if "running" in k or "gamma" in k} == \
        {"float32"}
    assert pd["output.weight"] == pd["features.0.weight"] == "float16"
    j = jnet(jmx.nd.array(x).astype("float16"))
    p = pnet(torch.from_numpy(x).half())
    assert p.dtype == torch.float16 and str(j.dtype) == "float16"
    np.testing.assert_allclose(_np(p), _np(j), rtol=0,
                               atol=2e-2 * np.abs(_np(j)).max())
    with ag.record():
        ag.backward(pnet(torch.from_numpy(x).half()).float().sum())
    assert pnet.output.weight.grad.dtype == torch.float16
    assert pnet.features[1].gamma.grad.dtype == torch.float32


def test_parameter_cast_keeps_the_tensor_and_casts_the_grad():
    net = gluon.nn.Dense(3, in_units=4, device="cpu")
    net.initialize()
    param = net.collect_params()["weight"]
    t = param.data()
    param.grad()
    param.cast("float16")
    assert param.data() is t and t.dtype == torch.float16
    assert t.grad.dtype == torch.float16
    assert net.collect_params()["weight"] is param
    param.cast(torch.float32)
    assert t.dtype == torch.float32 and t.grad.dtype == torch.float32


# ---------------------------------------------------------- trainer states
def _mlp(seed=0):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, in_units=4, activation="relu", device="cpu"),
            gluon.nn.Dense(3, in_units=8, device="cpu"))
    net.initialize(generator=torch.Generator().manual_seed(seed))
    return net


def _steps(net, trainer, n, seed=0):
    rng = np.random.RandomState(seed)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(n):
        x = torch.from_numpy(rng.randn(5, 4).astype("float32"))
        y = torch.from_numpy(rng.randint(0, 3, 5).astype("float32"))
        with ag.record():
            loss = loss_fn(net(x), y)
        ag.backward(loss)
        trainer.step(5)


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01)),
])
def test_trainer_save_and_load_states_resume_bitwise(tmp_path, opt_name, kw):
    """Two steps, ``save_states``, two more; a fresh Trainer on a copy of
    the two-step weights that ``load_states`` the file and takes the same
    two steps ends bit for bit where the first did (momentum, Adam's
    moments and its update counts all restored)."""
    net = _mlp()
    trainer = gluon.Trainer(net.collect_params(), opt_name, dict(kw))
    _steps(net, trainer, 2)
    fname = str(tmp_path / "t.states")
    trainer.save_states(fname)
    saved = {k: v.detach().clone() for k, v in net.state_dict().items()}
    _steps(net, trainer, 2, seed=1)
    other = _mlp(seed=7)
    other.load_state_dict(saved)
    trainer2 = gluon.Trainer(other.collect_params(), opt_name, dict(kw))
    trainer2.load_states(fname)
    assert trainer2._optimizer.param_dict[0] is \
        trainer2._params[0]
    _steps(other, trainer2, 2, seed=1)
    for k, v in net.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k


def test_trainer_states_match_jax_values():
    """The JAX package pickles its own NDArray and Optimizer classes, which
    the port, importing nothing of it, cannot load; across packages the
    states' values are held instead: the same weights, gradients and SGD
    momentum steps give the same momentum buffers (within 1e-6)."""
    rng = np.random.RandomState(6)
    ws = [rng.randn(3, 4).astype("float32"), rng.randn(4).astype("float32")]
    grads = [[rng.randn(*w.shape).astype("float32") for w in ws]
             for _ in range(2)]
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3)
    jps, pps = [], []
    for i, w in enumerate(ws):
        jp = jmx.gluon.Parameter(f"p{i}", shape=w.shape)
        jp.initialize()
        jp.set_data(jmx.nd.array(w))
        jps.append(jp)
        pp = gluon.Parameter(f"p{i}", shape=w.shape)
        pp.initialize(device="cpu")
        pp.set_data(torch.from_numpy(w))
        pps.append(pp)
    jtr = jmx.gluon.Trainer(jps, "sgd", dict(kw))
    ptr = gluon.Trainer(pps, "sgd", dict(kw))
    for gs in grads:
        for jp, pp, g in zip(jps, pps, gs):
            jp.grad()[:] = jmx.nd.array(g)
            pp.grad().copy_(torch.from_numpy(g))
        jtr.step(1)
        ptr.step(1)
    jstates = jtr._updaters[0].states
    for i in range(len(ws)):
        np.testing.assert_allclose(ptr._updater.states[i].numpy(),
                                   jstates[i].asnumpy(), atol=1e-6)


# ------------------------------------------------------ bf16/fp16 across
def test_convert_carries_bf16_and_fp16():
    """``bert_state_dict_from_gluon`` keeps fp16 and gives bf16 back as
    bf16 (carried as its exact fp32 values); ``module_params`` hands bf16
    over as fp32 arrays, which the port's ``Module.set_params`` casts to
    its arrays' dtype; ``load_from_gluon`` reads the JAX package's
    ``.params`` file of a bf16-cast block, which holds fp32."""
    rng = np.random.RandomState(7)
    w = rng.randn(6, 4).astype("float32")
    bf = jmx.nd.array(w).astype("bfloat16").asnumpy()
    half = w.astype("float16")
    out = convert.bert_state_dict_from_gluon(
        {"p_pooler_weight": bf, "p_pooler_bias": half[0],
         "p_nsp_weight": w}, "p_")
    assert out["pooler.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["pooler.weight"].float().numpy(),
                                  bf.astype("float32"))
    assert out["pooler.bias"].dtype == torch.float16
    assert out["nsp_classifier.weight"].dtype == torch.float32

    class Mod:
        def get_params(self):
            return ({"fc_weight": jmx.nd.array(w).astype("bfloat16")},
                    {"bn_moving_var": jmx.nd.array(w[0]).astype("float16")})
    arg, aux = convert.module_params(Mod())
    assert arg["fc_weight"].dtype == np.float32
    np.testing.assert_array_equal(arg["fc_weight"], bf.astype("float32"))
    assert aux["bn_moving_var"].dtype == np.float16


def test_load_from_gluon_casts_bf16_on_arrival(tmp_path):
    jnet = jmx.gluon.nn.Dense(6, in_units=4)
    jnet.initialize()
    jnet.cast("bfloat16")
    pnet = gluon.nn.Dense(6, in_units=4, device="cpu")
    pnet.cast("bfloat16")
    convert.load_from_gluon(jnet, pnet, tmp_path / "d.params")
    assert pnet.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(pnet.weight), _np(jnet.weight.data()))
    with pytest.raises(TypeError, match="file has"):
        pnet.load_parameters(str(tmp_path / "d.params"))
