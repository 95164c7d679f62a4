"""The port's training path against the JAX package's, on the CPU: losses,
the SGD update operators, the optimizer and its grouped update, ``Trainer``
and ``collect_params``, and whole ResNet training steps.

Every case feeds the same numpy inputs to both packages.  Tolerances are
stated per test; fp32 throughout.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import optimizer_ops as jops

from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, optimizer, telemetry
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.ops import optimizer_ops

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype="float32").copy())


# ------------------------------------------------------------------ losses
_LOSS_CASES = [
    ("SoftmaxCrossEntropyLoss", {}, (4, 5), "sparse", None),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, (4, 5), "dense",
     None),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True}, (4, 5), "sparse",
     None),
    ("SoftmaxCrossEntropyLoss", {"weight": 2.0}, (4, 5), "sparse", (4, 1)),
    ("SoftmaxCrossEntropyLoss", {"axis": 1}, (3, 4, 2), "sparse", None),
    ("SoftmaxCrossEntropyLoss", {"axis": 1, "batch_axis": 1}, (3, 4, 2),
     "sparse", None),
    ("L2Loss", {}, (4, 3), "same", None),
    ("L2Loss", {"weight": 0.5}, (4,), "same", (4,)),
    ("L1Loss", {}, (4, 3, 2), "same", (4, 1, 1)),
    ("L1Loss", {"batch_axis": 1}, (3, 4), "same", None),
]


@pytest.mark.parametrize("name,kwargs,shape,label,sw", _LOSS_CASES)
def test_loss_and_its_gradient_match_jax(name, kwargs, shape, label, sw):
    """Per-sample losses and the gradient with respect to the prediction
    (ones as head gradients) within 1e-6 (O(1) values)."""
    rng = np.random.RandomState(0)
    pred = rng.randn(*shape).astype("float32")
    axis = kwargs.get("axis", -1) % len(shape)
    if label == "sparse":
        lshape = shape[:axis] + shape[axis + 1:]
        lab = rng.randint(0, shape[axis], lshape).astype("float32")
    elif label == "dense":
        lab = rng.dirichlet(np.ones(shape[-1]), shape[0]).astype("float32")
    else:
        lab = rng.randn(*shape).astype("float32")
    weight = None if sw is None else rng.rand(*sw).astype("float32")

    jpred = jmx.nd.array(pred)
    jpred.attach_grad()
    with jag.record():
        jl = getattr(jgluon.loss, name)(**kwargs)(
            jpred, jmx.nd.array(lab),
            *(() if weight is None else (jmx.nd.array(weight),)))
    jl.backward()

    p = _t(pred)
    ag.mark_variables(p, torch.zeros_like(p))
    with ag.record():
        loss = getattr(gluon.loss, name)(**kwargs)(
            p, _t(lab), *(() if weight is None else (_t(weight),)))
    ag.backward(loss)
    np.testing.assert_allclose(loss.detach().numpy(), jl.asnumpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.grad.numpy(), jpred.grad.asnumpy(), rtol=0,
                               atol=ATOL)


# ------------------------------------------------------------ SGD operators
@pytest.mark.parametrize("kw", [
    dict(lr=0.1), dict(lr=0.1, wd=0.01), dict(lr=0.05, rescale_grad=0.25),
    dict(lr=0.1, wd=0.001, rescale_grad=0.5, clip_gradient=0.3),
    dict(lr=0.1, clip_gradient=-1.0)])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_operators_match_jax(kw, momentum):
    """Three in-place updates of ``sgd_update``/``sgd_mom_update`` against
    the JAX operators (atol 1e-6)."""
    rng = np.random.RandomState(1)
    w = rng.randn(5, 7).astype("float32")
    grads = [rng.randn(5, 7).astype("float32") * 3 for _ in range(3)]
    jw, jm = jmx.nd.array(w)._data, jmx.nd.zeros((5, 7))._data
    tw, tm = _t(w), torch.zeros(5, 7)
    for g in grads:
        if momentum:
            jw, jm = jops.sgd_mom_update(jw, jmx.nd.array(g)._data, jm,
                                         momentum=momentum, **kw)
            optimizer_ops.sgd_mom_update(tw, _t(g), tm, momentum=momentum,
                                         **kw)
        else:
            jw = jops.sgd_update(jw, jmx.nd.array(g)._data, **kw)
            optimizer_ops.sgd_update(tw, _t(g), **kw)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=ATOL)
    if momentum:
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                                   atol=ATOL)


# ------------------------------------------------------- optimizer, updater
def _params(pkg, shapes, lr_mults, wd_mults):
    out = []
    for i, (shape, lm, wm) in enumerate(zip(shapes, lr_mults, wd_mults)):
        p = pkg.Parameter(f"p{i}", shape=shape, lr_mult=lm, wd_mult=wm)
        out.append(p)
    return out


@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("opt_kw", [
    dict(learning_rate=0.1, momentum=0.9, wd=1e-2),
    dict(learning_rate=0.05, wd=1e-3, clip_gradient=0.5,
         rescale_grad=0.5),
    dict(learning_rate=0.1, momentum=0.5)])
def test_sgd_updater_matches_jax(aggregate, opt_kw):
    """An ``Updater`` over five parameters (one with ``lr_mult`` 0.5, one
    with ``wd_mult`` 0, one of another shape), three batched calls: the
    grouped ``_foreach`` path and the per-parameter path both match the JAX
    optimizer within 1e-6, and each other bit for bit."""
    rng = np.random.RandomState(2)
    shapes = [(3, 4), (3, 4), (7,), (2, 2, 2), (3, 4)]
    lr_mults, wd_mults = [1, 0.5, 1, 1, 1], [1, 1, 0, 1, 1]
    ws = [rng.randn(*s).astype("float32") for s in shapes]
    jparams = _params(jgluon, shapes, lr_mults, wd_mults)
    tparams = _params(gluon, shapes, lr_mults, wd_mults)
    jo = jopt.create("sgd", param_dict=dict(enumerate(jparams)), **opt_kw)
    to = optimizer.create("sgd", param_dict=dict(enumerate(tparams)),
                          **opt_kw)
    if not aggregate:
        to.aggregate_num = 1
    jup, tup = jopt.get_updater(jo), optimizer.get_updater(to)
    jw = [jmx.nd.array(w) for w in ws]
    tw = [_t(w) for w in ws]
    idx = list(range(len(ws)))
    for _ in range(3):
        gs = [rng.randn(*s).astype("float32") for s in shapes]
        jup(idx, [jmx.nd.array(g) for g in gs], jw)
        tup(idx, [_t(g) for g in gs], tw)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=0, atol=ATOL)
    assert to.num_update == 3 and to._index_update_count == {
        i: 3 for i in idx}

    # grouped and per-parameter give the same bits
    other = optimizer.create("sgd", param_dict=dict(enumerate(tparams)),
                             **opt_kw)
    other.aggregate_num = 256 if not aggregate else 1
    rng = np.random.RandomState(2)
    ws2 = [_t(rng.randn(*s)) for s in shapes]
    up2 = optimizer.get_updater(other)
    for _ in range(3):
        up2(idx, [_t(rng.randn(*s)) for s in shapes], ws2)
    for a, b in zip(tw, ws2):
        assert torch.equal(a, b)


def test_grouped_update_takes_tied_and_mixed_members_one_by_one():
    """A weight listed twice and a gradient of another dtype cannot join a
    group: they take the per-parameter path, with the same result."""
    opt = optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    w = [torch.ones(3), torch.ones(3), torch.ones(2)]
    g = [torch.ones(3), torch.ones(3), torch.ones(2, dtype=torch.float64)]
    states = [opt.create_state(i, x) for i, x in enumerate(w)]
    opt.update_multi([0, 1, 2], w, g, states)
    ref = optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    rw = [torch.ones(3), torch.ones(3), torch.ones(2)]
    for i in range(3):
        ref.update(i, rw[i], g[i], ref.create_state(i, rw[i]))
    for a, b in zip(w, rw):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tied = torch.ones(3)
    opt.update_multi([3, 4], [tied, tied], [torch.ones(3)] * 2,
                     [torch.zeros(3), torch.zeros(3)])
    # two momentum updates of lr 0.1 on the same tensor
    torch.testing.assert_close(tied, torch.full((3,), 0.8), rtol=0,
                               atol=1e-7)


def test_multiplier_precedence():
    """An attached Parameter's multiplier wins, then an index entry, then a
    name entry; the name rule zeroes wd for Module-path names other than
    ``*_weight``/``*_gamma``, and does not reach Gluon Parameters."""
    p = gluon.Parameter("fc_bias", shape=(2,), lr_mult=0.3, wd_mult=2.0)
    opt = optimizer.SGD(learning_rate=1.0, wd=0.1, param_dict={0: p},
                        param_idx2name={0: "fc_bias", 1: "fc_bias",
                                        2: "fc_weight"})
    opt.set_lr_mult({1: 0.7, "fc_weight": 0.2})
    assert opt._get_lrs([0, 1, 2, 3]) == [0.3, 0.7, 0.2, 1.0]
    assert opt._get_wds([0, 1, 2]) == [0.1 * 2.0, 0.0, 0.1]
    jp = jgluon.Parameter("fc_bias", shape=(2,), lr_mult=0.3, wd_mult=2.0)
    jo = jopt.SGD(learning_rate=1.0, wd=0.1, param_dict={0: jp},
                  param_idx2name={0: "fc_bias", 1: "fc_bias",
                                  2: "fc_weight"})
    jo.set_lr_mult({1: 0.7, "fc_weight": 0.2})
    assert jo._get_lrs([0, 1, 2, 3]) == opt._get_lrs([0, 1, 2, 3])
    assert jo._get_wds([0, 1, 2]) == opt._get_wds([0, 1, 2])
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        optimizer.create("nosuch")


# ----------------------------------------------------------------- Trainer
def _param(name, shape, init):
    p = gluon.Parameter(name, shape=shape)
    p.initialize(init=init, device="cpu")
    return p


def test_trainer_step_math_and_lr_mult():
    """``test_gluon_trainer.py``'s momentum trajectory on grad == 1, then
    ``lr_mult`` folded into the momentum buffer."""
    x = _param("x", (10,), "zeros")
    trainer = gluon.Trainer([x], "sgd",
                            {"learning_rate": 1.0, "momentum": 0.5})
    for expect in (-1.0, -2.5):
        with ag.record():
            y = x.data() + 1
        ag.backward(y)
        trainer.step(1)
        np.testing.assert_allclose(x.data().detach().numpy(),
                                   np.full(10, expect))
    x.lr_mult = 0.5
    with ag.record():
        y = x.data() + 1
    ag.backward(y)
    trainer.step(1)
    np.testing.assert_allclose(x.data().detach().numpy(), np.full(10, -3.75),
                               rtol=1e-6)


def test_trainer_steps_without_gradients_and_learning_rate():
    """Zeroed gradients leave the weight alone (no wd); ``set_learning_rate``
    reaches the optimizer."""
    x = _param("x", (3,), "ones")
    trainer = gluon.Trainer([x], "sgd", {"learning_rate": 0.5})
    with ag.record():
        y = x.data().sum()
    ag.backward(y)
    trainer.step(1)
    w1 = x.data().detach().clone()
    x.zero_grad()
    trainer.step(1)
    torch.testing.assert_close(x.data().detach(), w1)
    trainer.set_learning_rate(0.05)
    assert trainer.learning_rate == 0.05
    fresh = _param("f", (2,), "ones")
    gluon.Trainer([fresh], "sgd", {"learning_rate": 0.5}).step(4)
    torch.testing.assert_close(fresh.data().detach(), torch.ones(2))


def test_trainer_multiple_params_distinct_states():
    a, b = _param("a", (2,), "zeros"), _param("b", (3,), "zeros")
    trainer = gluon.Trainer([a, b], "sgd",
                            {"learning_rate": 1.0, "momentum": 0.9})
    with ag.record():
        ya, yb = a.data() + 1, (b.data() * 2).sum()
    ag.backward([ya, yb])
    trainer.step(1)
    np.testing.assert_allclose(a.data().detach().numpy(), [-1, -1])
    np.testing.assert_allclose(b.data().detach().numpy(), [-2, -2, -2])


def test_trainer_rejects_and_records():
    with pytest.raises(ValueError, match="Parameters"):
        gluon.Trainer([torch.ones(2)], "sgd")
    with pytest.raises(ValueError, match="Parameters"):
        gluon.Trainer(torch.ones(2), "sgd")
    x = _param("x", (2,), "ones")
    with pytest.raises(ValueError, match="optimizer_params"):
        gluon.Trainer([x], optimizer.SGD(), {"learning_rate": 1.0})
    trainer = gluon.Trainer([x], "sgd", {"learning_rate": 0.1})
    telemetry.enable()
    telemetry.reset()
    try:
        trainer.step(2)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    assert snap["counters"]["trainer.steps"] == 1
    assert {"trainer.step", "trainer.update"} <= set(snap["spans"])


def test_collect_params_names_reqs_and_persistent_settings():
    """Structural names, ``select``, ``grad_req='null'`` running statistics
    that the trainer skips, and settings that last across calls."""
    net = get_model("resnet18_v1", classes=10, device="cpu")
    net.initialize()
    net(torch.zeros(1, 3, 32, 32))
    params = net.collect_params()
    assert set(params) == set(net._collect_params_with_prefix())
    assert params["features.1.running_var"].grad_req == "null"
    assert params["features.1.gamma"].grad_req == "write"
    bn = net.collect_params(".*running_mean")
    assert bn and all(k.endswith("running_mean") for k in bn)
    params["output.weight"].lr_mult = 0.0
    assert net.collect_params()["output.weight"].lr_mult == 0.0
    assert net.collect_params()["output.weight"] is params["output.weight"]
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        params["features.1.running_mean"].grad()
    before = net.features[1].running_mean.clone()
    w_out = net.output.weight.detach().clone()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                            "momentum": 0.9})
    with ag.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(torch.randn(2, 3, 32, 32)), torch.tensor([1.0, 2.0]))
    ag.backward(loss)
    trainer.step(2)
    after = net.features[1].running_mean
    assert not torch.equal(before, after)      # moved by the forward only
    torch.testing.assert_close(net.output.weight.detach(), w_out)   # lr 0


def test_grad_req_add_and_null_on_a_block():
    dense = gluon.nn.Dense(2, in_units=3, device="cpu")
    dense.initialize()
    params = dense.collect_params()
    params["weight"].grad_req = "add"
    params["bias"].grad_req = "null"
    x = torch.ones(4, 3)
    for _ in range(2):
        with ag.record():
            y = dense(x)
        ag.backward(y)
    torch.testing.assert_close(dense.weight.grad, torch.full((2, 3), 8.0))
    assert dense.bias.grad is None and not dense.bias.requires_grad
    params["weight"].grad_req = "write"
    with ag.record():
        y = dense(x)
    ag.backward(y)
    torch.testing.assert_close(dense.weight.grad, torch.full((2, 3), 4.0))


# --------------------------------------------------------- the whole slice
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
STEPS = 3


def _seeded(name, shape, rng):
    """As ``test_torch_resnet.py`` seeds a net: BN statistics with
    variance > 0, He-scaled weights, gammas under one."""
    if name.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if name.endswith(("running_mean", "beta", "bias")):
        return rng.normal(0, 0.1, shape)
    if name.endswith("gamma"):
        return rng.uniform(0.2, 0.6, shape)
    fan_in = int(np.prod(shape[1:]))
    return rng.normal(0, np.sqrt(2.0 / fan_in), shape)


def _train_jax(name, path, x, y, perm):
    """STEPS steps of the JAX package on the batch in the order ``perm``:
    per-sample losses (in the original order), step-1 gradients, final
    parameters and running statistics."""
    net = jvision.get_model(name, classes=10)
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
    net = get_model(name, classes=10, device="cpu")
    net.load_parameters(path)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = net.collect_params()
    losses, grads = [], None
    for step in range(STEPS):
        with ag.record():
            loss = loss_fn(net(_t(x)), _t(y))
        ag.backward(loss)
        losses.append(loss.detach().numpy())
        if step == 0:
            grads = {k: p.grad().clone().numpy() for k, p in params.items()
                     if p.grad_req != "null"}
        trainer.step(len(x))
    return losses, grads, {k: p.data().detach().numpy()
                           for k, p in params.items()}


def _rel(a, b):
    """max |a - b| over max |b|, each tensor; the largest of them."""
    keys = sorted(b)
    assert sorted(a) == keys and keys
    return max(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)
               for k in keys)


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1"])
def test_resnet_training_steps_match_jax(name, tmp_path):
    """Three SGD steps (lr 0.01, momentum 0.9, wd 1e-4) of a ResNet v1
    (10 classes, input (4, 3, 64, 64)) from the same weights, carried
    through a ``.params`` file: the step-1 gradients, the per-step losses
    and every parameter and running statistic after step 3.

    Tolerance, per quantity, of the largest error relative to each
    tensor's max magnitude: 1e-4, or twice the JAX package's own spread if
    that is larger.  The spread is measured here: the JAX run again with
    the batch in two other orders (the same training in exact arithmetic),
    the larger distance from the first run.  ResNet-18 is not chaotic at
    this size: its spread is ~2e-5 and the 1e-4 floor holds.  ResNet-50
    is: training-mode BatchNorm over 16 values a channel (2x2 maps at
    batch 4) turns a ReLU input within fp32 rounding of zero into an O(1)
    change of its channel's gradient, and three steps at lr 0.01 amplify
    it.  Reordering the batch moves the JAX package's own step-1 gradients
    by 0.17-0.22, its parameters after step 3 by 0.30-0.37 and its step-3
    losses by 0.17-0.33 of their max; the port sits inside that range
    (0.17, 0.33, 0.36).  Its step-1 losses, before any update, agree to
    ~1e-4 in both."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 64, 64).astype("float32")
    y = rng.randint(0, 10, 4).astype("float32")
    jnet = jvision.get_model(name, classes=10)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    seeds = np.random.RandomState(1)
    for pname, p in sorted(jnet._collect_params_with_prefix().items()):
        p.set_data(jmx.nd.array(_seeded(pname, p.shape, seeds)
                                .astype("float32")))
    path = str(tmp_path / "w.params")
    jnet.save_parameters(path)

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
