"""The port's optimizers and update operators against the JAX package's, on
the CPU.

Every case feeds the same numpy weights and gradients to both packages:
the sixteen optimizers through an ``Updater`` over five parameters (one
with ``lr_mult`` 0.5, one with ``wd_mult`` 0, one of another shape), five
batched calls, with and without weight decay, ``clip_gradient``,
``rescale_grad``, an lr scheduler and ``multi_precision``; the update
operators through ``mx.nd`` with their in-place writes; ``Trainer`` and
``Module`` with ``"nag"`` and ``"rmsprop"``.  The JAX side runs its
per-parameter path (its grouped FTML rule moves by up to 2e-4 from its
own per-parameter op: ``tests/test_optimizer_aggregate.py``).

Tolerance: 1e-6 of each tensor's largest magnitude (fp32; the two
packages take the same steps in the same order).  The port's grouped and
per-parameter updates must agree bit for bit.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, lr_scheduler, optimizer
from mxnet_tpu_torch.ops import optimizer_ops

RTOL = 1e-6
SHAPES = [(3, 4), (3, 4), (7,), (2, 2, 2), (3, 4)]
LR_MULTS, WD_MULTS = [1, 0.5, 1, 1, 1], [1, 1, 0, 1, 1]
STEPS = 5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(port, ref, rtol=RTOL):
    ref = np.asarray(ref, dtype="float64")
    np.testing.assert_allclose(np.asarray(port, dtype="float64"), ref,
                               rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _params(pkg):
    return [pkg.Parameter(f"p{i}", shape=s, lr_mult=lm, wd_mult=wm)
            for i, (s, lm, wm) in enumerate(zip(SHAPES, LR_MULTS, WD_MULTS))]


def _data(seed, dtype="float32"):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(dtype) for s in SHAPES]
    grads = [[rng.randn(*s).astype(dtype) for s in SHAPES]
             for _ in range(STEPS)]
    return ws, grads


def _sched(pkg):
    return pkg.FactorScheduler(step=2, factor=0.5)


def _kw(kw, pkg):
    kw = dict(kw)
    if kw.pop("sched", False):
        kw["lr_scheduler"] = _sched(pkg)
    return kw


def _run_jax(name, kw, ws, grads, dtype="float32"):
    o = jopt.create(name, param_dict=dict(enumerate(_params(jgluon))),
                    **_kw(kw, jsched))
    o.aggregate_num = 1
    up = jopt.get_updater(o)
    jw = [jmx.nd.array(w, dtype=dtype) for w in ws]
    idx = list(range(len(ws)))
    for gs in grads:
        up(idx, [jmx.nd.array(g, dtype=dtype) for g in gs], jw)
    return [w.asnumpy() for w in jw], up


def _run_port(name, kw, ws, grads, aggregate, dtype=torch.float32,
              chunk=256):
    """The port's Updater; ``aggregate`` groups up to ``chunk`` members."""
    o = optimizer.create(name, param_dict=dict(enumerate(_params(gluon))),
                         **_kw(kw, lr_scheduler))
    o.aggregate_num = chunk if aggregate else 1
    up = optimizer.get_updater(o)
    tw = [_t(w).to(dtype) for w in ws]
    idx = list(range(len(ws)))
    for gs in grads:
        up(idx, [_t(g).to(dtype) for g in gs], tw)
    return tw, up


_BASE = {
    "signum": dict(learning_rate=0.01, momentum=0.9),
    "ftml": dict(learning_rate=0.01),
    "lbsgd": dict(learning_rate=0.1, momentum=0.9),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9, lamda=0.1),
    "nag": dict(learning_rate=0.1, momentum=0.9),
    "ccsgd": dict(learning_rate=0.1, momentum=0.9),
    "adagrad": dict(learning_rate=0.1),
    "rmsprop": dict(learning_rate=0.01),
    "adadelta": dict(rho=0.9, epsilon=1e-5),
    "ftrl": dict(learning_rate=0.1, lamda1=0.02),
    "adamax": dict(learning_rate=0.002),
    "nadam": dict(learning_rate=0.001),
    "test": dict(rescale_grad=0.5),
}
_VARIANTS = [
    ("plain", {}),
    ("wd", dict(wd=0.01)),
    ("clip_rescale_sched", dict(wd=0.001, clip_gradient=0.5,
                                rescale_grad=0.5, sched=True)),
]
_EXTRA = [
    ("signum", dict(learning_rate=0.01, momentum=0.0, wd=0.01)),
    ("signum", dict(learning_rate=0.01, momentum=0.8, wd_lh=0.01)),
    ("nag", dict(learning_rate=0.1, wd=0.01)),
    ("dcasgd", dict(learning_rate=0.1, wd=0.01)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9,
                   warmup_strategy="lars", batch_scale=2)),
    ("lbsgd", dict(learning_rate=0.1, warmup_strategy="power2",
                   batch_scale=2, warmup_epochs=1, updates_per_epoch=4)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, clip_weights=0.5, gamma1=0.8)),
    ("ftml", dict(learning_rate=0.01, beta1=0.7, wd=0.01)),
    ("ftrl", dict(learning_rate=0.1, beta=0.5, wd=0.01)),
    ("nadam", dict(learning_rate=0.001, schedule_decay=0.01,
                   clip_gradient=0.1)),
]
CASES = [(n, dict(_BASE[n], **v)) for n in _BASE for _, v in _VARIANTS
         if not (n == "test" and v)] + _EXTRA


@pytest.mark.parametrize("name,kw", CASES)
def test_optimizer_matches_jax(name, kw):
    """Five updates of five parameters: the weights and every state tensor
    against the JAX package within 1e-6 of each tensor's max; grouped and
    per-parameter the same bits."""
    ws, grads = _data(0)
    ref, jup = _run_jax(name, kw, ws, grads)
    got, tup = _run_port(name, kw, ws, grads, aggregate=True)
    for a, b in zip(got, ref):
        _close(a.numpy(), b)
    for i in range(len(ws)):
        js, ts = jup.states[i], tup.states[i]
        jl = [s for s in (js if isinstance(js, (tuple, list)) else [js])
              if s is not None]
        tl = [s for s in (ts if isinstance(ts, (tuple, list)) else [ts])
              if s is not None]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            _close(a.numpy(), b.asnumpy())
    per, _ = _run_port(name, kw, ws, grads, aggregate=False)
    for a, b in zip(got, per):
        assert torch.equal(a, b)


_MP = ["signum", "ftml", "nag", "adagrad", "rmsprop", "ftrl", "adamax",
       "nadam"]


@pytest.mark.parametrize("name", _MP)
def test_multi_precision_matches_jax(name):
    """fp16 weights with ``multi_precision=True``: the fp32 master copies
    against the JAX package's within 1e-6 of their max, each fp16 weight
    equal to its master rounded, and the grouped update (fp16 members
    grouped through their masters) the per-parameter one bit for bit."""
    kw = dict(_BASE[name], wd=0.01, multi_precision=True)
    ws, grads = _data(1, "float16")
    _, jup = _run_jax(name, kw, ws, grads, dtype="float16")
    got, tup = _run_port(name, kw, ws, grads, True, torch.float16)
    for i, w in enumerate(got):
        master = tup.states[i][0]
        assert master.dtype == torch.float32 and w.dtype == torch.float16
        _close(master.numpy(), jup.states[i][0].asnumpy())
        assert torch.equal(w, master.half())
    per, _ = _run_port(name, kw, ws, grads, False, torch.float16)
    for a, b in zip(got, per):
        assert torch.equal(a, b)


def test_sgld_noise_has_the_langevin_moments():
    """SGLD's step is ``-lr / 2 (g + wd w)`` plus Gaussian noise of
    variance ``lr``: the deterministic part against the JAX formula, the
    noise by its mean and variance over 200k draws (5 standard errors),
    and the same seed gives the same noise."""
    lr, wd = 0.04, 0.01
    rng = np.random.RandomState(3)
    w0 = rng.randn(200_000).astype("float32")
    g = rng.randn(200_000).astype("float32")
    det = w0 - lr / 2 * (g + wd * w0)

    def run():
        mx.random.seed(7)
        o = optimizer.create("sgld", learning_rate=lr, wd=wd)
        w = _t(w0)
        o.update(0, w, _t(g), o.create_state(0, w))
        return w
    w = run()
    noise = w.double().numpy() - det
    n = noise.size
    assert abs(noise.mean()) < 5 * math.sqrt(lr / n)
    assert abs(noise.var() - lr) < 5 * lr * math.sqrt(2.0 / n)
    assert torch.equal(w, run())


def test_registry_names_and_create():
    """Every JAX optimizer name creates the port's class of the same name;
    an unknown name raises."""
    for name, cls in jopt.Optimizer.opt_registry.items():
        o = optimizer.create(name)
        assert type(o).__name__ == cls.__name__
    assert sorted(optimizer.Optimizer.opt_registry) == \
        sorted(jopt.Optimizer.opt_registry)
    with pytest.raises(ValueError, match="Cannot find"):
        optimizer.create("nosuch")


def test_nadam_groups_only_in_one_piece():
    """Nadam's momentum schedule runs over members in order: a group that
    would split (an fp16 multi-precision member beside fp32 ones) takes
    the per-parameter path, and the schedule matches it exactly."""
    rng = np.random.RandomState(4)
    shapes = [(3,), (4,), (5,)]
    dtypes = [torch.float32, torch.float16, torch.float32]
    results = []
    for agg in (256, 1):
        o = optimizer.create("nadam", learning_rate=0.01,
                             multi_precision=True)
        o.aggregate_num = agg
        up = optimizer.get_updater(o)
        r = np.random.RandomState(4)
        ws = [_t(r.randn(*s).astype("float32")).to(d)
              for s, d in zip(shapes, dtypes)]
        for _ in range(3):
            up([0, 1, 2], [_t(r.randn(*s).astype("float32")).to(d)
                           for s, d in zip(shapes, dtypes)], ws)
        results.append((ws, o.m_schedule))
    assert results[0][1] == results[1][1]
    for a, b in zip(results[0][0], results[1][0]):
        assert torch.equal(a, b)
    del rng


# ------------------------------------------------------------ update ops
S = (3, 4)
OPS = [
    ("nag_mom_update", 3, dict(lr=0.1, momentum=0.9, wd=0.01)),
    ("nag_mom_update", 3, dict(lr=0.1, momentum=0.5, rescale_grad=0.5,
                               clip_gradient=0.3)),
    ("rmsprop_update", 3, dict(lr=0.01, gamma1=0.9, wd=0.01)),
    ("rmsprop_update", 3, dict(lr=0.01, clip_weights=0.5, epsilon=1e-6)),
    ("rmspropalex_update", 5, dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                   wd=0.01)),
    ("ftrl_update", 4, dict(lr=0.1, lamda1=0.02, beta=0.5, wd=0.01)),
    ("signsgd_update", 2, dict(lr=0.1, wd=0.01, clip_gradient=0.5)),
    ("signum_update", 3, dict(lr=0.1, momentum=0.9, wd_lh=0.01)),
    ("ftml_update", 5, dict(lr=0.01, beta1=0.6, t=3, wd=0.01)),
    ("adagrad_update", 3, dict(lr=0.1, epsilon=1e-7, wd=0.01)),
    ("_sparse_adagrad_update", 3, dict(lr=0.1, rescale_grad=0.5)),
    ("adamw_update", 4, dict(lr=0.01, eta=0.5, wd=0.1, rescale_grad=0.5)),
    ("_contrib_adamw_update", 4, dict(lr=0.01, beta1=0.8, wd=0.01,
                                      clip_gradient=0.2)),
]


@pytest.mark.parametrize("name,arity,attrs", OPS)
def test_update_op_writes_in_place_like_jax(name, arity, attrs):
    """``mx.nd.<op>(weight, grad, *states, **attrs)`` three times: every
    written input (weight and states) against the JAX op's within 1e-6 of
    its max, written in place (the same tensors), and the op returns the
    weight."""
    rng = np.random.RandomState(5)
    arrays = [rng.randn(*S).astype("float32") for _ in range(arity)]
    # second-moment states start non-negative
    for k in range(2, arity):
        if name.startswith(("rmsprop", "ftrl", "ftml", "adagrad",
                            "_sparse_adagrad", "adamw", "_contrib_adamw")):
            arrays[k] = np.abs(arrays[k])
    if name.startswith("rmspropalex"):
        arrays[3] = np.zeros(S, "float32")     # g^2 <= n
    j = [jmx.nd.array(a) for a in arrays]
    t = [mx.nd.array(a, ctx=mx.cpu()) for a in arrays]
    tensors = [x._data for x in t]
    for step in range(3):
        g = rng.randn(*S).astype("float32")
        j[1], t[1] = jmx.nd.array(g), mx.nd.array(g, ctx=mx.cpu())
        getattr(jmx.nd, name)(*j, out=j[0], **attrs)
        out = getattr(mx.nd, name)(*t, **attrs)
        assert out is t[0]
    for k in [0] + list(range(2, arity)):
        assert t[k]._data is tensors[k]
        _close(t[k].asnumpy(), j[k].asnumpy())


def test_adamw_takes_rescale_as_an_array():
    """MXNet's AdamW takes ``rescale_grad`` as a fifth input (AMP's loss
    scale): the same result as the attribute."""
    rng = np.random.RandomState(6)
    w, g, m, v = (rng.randn(*S).astype("float32") for _ in range(4))
    v = np.abs(v)
    a = [_t(x) for x in (w, g, m, v)]
    b = [_t(x) for x in (w, g, m, v)]
    mx.nd.adamw_update(*[mx.nd.NDArray(x) for x in a],
                       mx.nd.array([0.25], ctx=mx.cpu()), lr=0.01, wd=0.1)
    optimizer_ops.adamw_update(*b, lr=0.01, wd=0.1, rescale_grad=0.25)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --------------------------------------------------------- Trainer, Module
@pytest.mark.parametrize("name,kw", [
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, wd=0.01))])
def test_trainer_matches_jax(name, kw):
    """A Dense(4) -> Dense(3) net, ``Trainer(params, name)``, three steps
    of ``L2Loss`` at batch 6, weights carried through a ``.params``
    file: every parameter after step 3 within 1e-5 of its max (two
    products and a sum of squares in different orders)."""
    import tempfile
    from mxnet_tpu import autograd as jag
    from mxnet_tpu_torch import autograd as ag
    rng = np.random.RandomState(7)
    x = rng.randn(6, 5).astype("float32")
    y = rng.randn(6, 3).astype("float32")
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(4, activation="relu", in_units=5),
             jgluon.nn.Dense(3, in_units=4))
    jnet.initialize(jmx.init.Xavier())
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, activation="relu", in_units=5,
                           device="cpu"),
            gluon.nn.Dense(3, in_units=4, device="cpu"))
    with tempfile.TemporaryDirectory() as d:
        jnet.save_parameters(f"{d}/w.params")
        net.load_parameters(f"{d}/w.params")
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(kw))
    tr = gluon.Trainer(net.collect_params(), name, dict(kw))
    jloss, loss = jgluon.loss.L2Loss(), gluon.loss.L2Loss()
    for _ in range(3):
        with jag.record():
            jl = jloss(jnet(jmx.nd.array(x)), jmx.nd.array(y))
        jl.backward()
        jtr.step(6)
        with ag.record():
            tl = loss(net(_t(x)), _t(y))
        ag.backward(tl)
        tr.step(6)
    jp = [p.data().asnumpy() for p in jnet.collect_params().values()]
    tp = [p.data().detach().numpy() for p in net.collect_params().values()]
    assert len(jp) == len(tp)
    for a, b in zip(tp, jp):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("name,kw", [
    ("nag", dict(learning_rate=0.1, momentum=0.9)),
    ("rmsprop", dict(learning_rate=0.01))])
def test_module_matches_jax(name, kw):
    """A symbolic MLP through ``Module.forward_backward`` and ``update``
    (kvstore ``local``) with ``init_optimizer(optimizer=name)``, three
    steps from the same parameters: every parameter within 1e-5 of its
    max."""
    rng = np.random.RandomState(8)
    x = rng.randn(8, 6).astype("float32")
    y = rng.randint(0, 3, 8).astype("float32")

    def sym(pkg):
        d = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(d, num_hidden=5, name="fc1")
        h = pkg.sym.Activation(h, act_type="relu", name="relu1")
        h = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return pkg.sym.SoftmaxOutput(h, name="softmax")

    arg = {"fc1_weight": rng.randn(5, 6) * 0.3, "fc1_bias": np.zeros(5),
           "fc2_weight": rng.randn(3, 5) * 0.3, "fc2_bias": np.zeros(3)}

    def run(pkg, ctx):
        mod = pkg.mod.Module(sym(pkg), context=ctx)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        mod.init_params()
        mod.set_params({k: pkg.nd.array(v.astype("float32"), ctx=ctx)
                        for k, v in arg.items()}, {})
        mod.init_optimizer(kvstore="local", optimizer=name,
                           optimizer_params=dict(kw))
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)])
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    ref = run(jmx, jmx.cpu())
    got = run(mx, mx.cpu())
    assert sorted(ref) == sorted(got)
    for k in ref:
        _close(got[k], ref[k], 1e-5)


def test_update_ops_cover_the_jax_table():
    """Every update operator of the JAX package's ``optimizer_ops`` is in
    the port's op table under the same names and aliases, and writes in
    place through ``mx.nd``."""
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry
    names = [n for n in jreg.all_names()
             if jreg.get(n).fn.__module__ == "mxnet_tpu.ops.optimizer_ops"]
    assert len(names) >= 17
    missing = [n for n in names if registry.get(n) is None]
    assert not missing, missing
    for n in names:
        for alias in jreg.get(n).aliases:
            assert registry.get(alias) is registry.get(n), (n, alias)
    assert set(optimizer_ops.INPLACE_UPDATES) >= {
        n for n in names if "finite" not in n}


def test_grouped_rules_chunk_and_skip_subclasses():
    """``aggregate_num`` cuts a group into chunks with the same result; a
    subclass of a grouped optimizer that overrides ``update`` keeps the
    per-parameter path (exact classes only, as the JAX package); a
    ``clip_gradient`` of 0 clips nothing on either path."""
    ws, grads = _data(2)
    full, _ = _run_port("nag", _BASE["nag"], ws, grads, aggregate=True)
    chunked, _ = _run_port("nag", _BASE["nag"], ws, grads, True, chunk=2)
    for a, b in zip(full, chunked):
        assert torch.equal(a, b)

    calls = []

    class Logged(optimizer.NAG):
        def update(self, index, weight, grad, state):
            calls.append(index)
            super().update(index, weight, grad, state)

    lo = Logged(**_BASE["nag"])
    up = optimizer.get_updater(lo)
    up([0, 1], [_t(g) for g in grads[0][:2]], [_t(w) for w in ws[:2]])
    assert calls == [0, 1]

    for agg in (True, False):
        zero, _ = _run_port("rmsprop", dict(_BASE["rmsprop"],
                                            clip_gradient=0.0), ws, grads,
                            agg)
        none, _ = _run_port("rmsprop", _BASE["rmsprop"], ws, grads, agg)
        for a, b in zip(zero, none):
            assert torch.equal(a, b)


def test_rmsprop_and_nag_trajectories_match_numpy():
    """Five updates of one tensor against the formulas written out in
    numpy (float64): RMSProp (plain) and NAG, as the optimizer half of
    ``tests/test_loss_optimizer_numerics.py`` checks the JAX package."""
    rng = np.random.RandomState(9)
    w0 = rng.randn(6).astype("float32")
    grads = [rng.randn(6).astype("float32") for _ in range(5)]

    def run(name, **kw):
        o = optimizer.create(name, learning_rate=0.1, **kw)
        w = _t(w0)
        s = o.create_state(0, w)
        for g in grads:
            o.update(0, w, _t(g), s)
        return w.double().numpy()

    w, n = w0.astype("float64"), np.zeros(6)
    for g in grads:
        n = 0.1 * g * g + 0.9 * n
        w = w - 0.1 * g / np.sqrt(n + 1e-8)
    np.testing.assert_allclose(run("rmsprop"), w, rtol=2e-5, atol=1e-6)
    w, m = w0.astype("float64"), np.zeros(6)
    for g in grads:
        m = 0.9 * m + g
        w = w - 0.1 * (g + 0.9 * m)
    np.testing.assert_allclose(run("nag", momentum=0.9), w, rtol=2e-5,
                               atol=1e-6)
