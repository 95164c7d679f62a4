"""The port's training path against the JAX package's, on the CPU: losses,
the SGD and Adam update operators, the optimizers and their grouped
updates, the learning-rate schedulers, ``Trainer`` and ``collect_params``,
``Dense`` activations, and whole ResNet training steps.

Every case feeds the same numpy inputs to both packages.  Tolerances are
stated per test; fp32 throughout.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import optimizer_ops as jops

from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon, lr_scheduler, optimizer, telemetry
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


# ----------------------------------------------------------------- Adam
_ADAM_KW = [dict(lr=0.01), dict(lr=0.01, wd=0.01),
            dict(lr=0.005, rescale_grad=0.25, clip_gradient=0.3),
            dict(lr=0.01, wd=0.001, rescale_grad=0.5, clip_gradient=0.3,
                 beta1=0.8, beta2=0.99, epsilon=1e-6)]


@pytest.mark.parametrize("kw", _ADAM_KW)
def test_adam_operator_matches_jax(kw):
    """Three in-place ``adam_update`` calls, without and with clip and wd,
    against the JAX operator: weight, mean and variance within 1e-6."""
    rng = np.random.RandomState(5)
    w = rng.randn(5, 7).astype("float32")
    grads = [rng.randn(5, 7).astype("float32") * 3 for _ in range(3)]
    jw, jm, jv = jmx.nd.array(w)._data, jmx.nd.zeros((5, 7))._data, \
        jmx.nd.zeros((5, 7))._data
    tw, tm, tv = _t(w), torch.zeros(5, 7), torch.zeros(5, 7)
    for g in grads:
        jw, jm, jv = jops.adam_update(jw, jmx.nd.array(g)._data, jm, jv, **kw)
        optimizer_ops.adam_update(tw, _t(g), tm, tv, **kw)
    for port, ref in ((tw, jw), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("opt_kw", [
    dict(learning_rate=0.01, wd=1e-2),
    dict(learning_rate=0.005, wd=1e-3, clip_gradient=0.5, rescale_grad=0.5,
         beta1=0.8, beta2=0.99)])
def test_adam_updater_matches_jax(aggregate, opt_kw):
    """Adam through an ``Updater`` over five parameters (``lr_mult`` 0.5 on
    one, ``wd_mult`` 0 on another), three batched calls, so that the bias
    correction sees t = 1, 2, 3: the grouped and the per-parameter path
    match the JAX optimizer within 1e-6 and each other bit for bit."""
    rng = np.random.RandomState(6)
    shapes = [(3, 4), (3, 4), (7,), (2, 2, 2), (3, 4)]
    lr_mults, wd_mults = [1, 0.5, 1, 1, 1], [1, 1, 0, 1, 1]
    ws = [rng.randn(*s).astype("float32") for s in shapes]
    grads = [[rng.randn(*s).astype("float32") for s in shapes]
             for _ in range(3)]
    jparams = _params(jgluon, shapes, lr_mults, wd_mults)
    jo = jopt.create("adam", param_dict=dict(enumerate(jparams)), **opt_kw)
    jup = jopt.get_updater(jo)
    jw = [jmx.nd.array(w) for w in ws]
    idx = list(range(len(ws)))
    for gs in grads:
        jup(idx, [jmx.nd.array(g) for g in gs], jw)

    results = []
    for agg in (aggregate, not aggregate):
        tparams = _params(gluon, shapes, lr_mults, wd_mults)
        to = optimizer.create("adam", param_dict=dict(enumerate(tparams)),
                              **opt_kw)
        to.aggregate_num = 256 if agg else 1
        tup = optimizer.get_updater(to)
        tw = [_t(w) for w in ws]
        for gs in grads:
            tup(idx, [_t(g) for g in gs], tw)
        assert to._index_update_count == {i: 3 for i in idx}
        results.append(tw)
    for a, b in zip(results[0], jw):
        np.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=0, atol=ATOL)
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_adam_trainer_matches_jax():
    """``Trainer(..., "adam")`` on two parameters over three steps of
    ``y = sum(w * x)`` (lr 0.1, wd 0.01), against the JAX Trainer and
    against the same trajectory in float64.  The port lands within 3e-7 of
    float64.  The JAX Trainer's grouped update is one jitted XLA program
    that lands up to 2e-6 from float64 here (measured: its division and
    square root are not the correctly rounded ones), so the two packages
    are held within 1e-5 of each other."""
    rng = np.random.RandomState(7)
    init = [rng.randn(4).astype("float32"), rng.randn(2, 3).astype("float32")]
    xs = [[rng.randn(4).astype("float32"), rng.randn(2, 3).astype("float32")]
          for _ in range(3)]
    jp = [jgluon.Parameter(f"j{i}", shape=w.shape) for i, w in
          enumerate(init)]
    for p, w in zip(jp, init):
        p.initialize(init=jmx.init.Constant(0))
        p.set_data(jmx.nd.array(w))
    jt = jgluon.Trainer(jp, "adam", {"learning_rate": 0.1, "wd": 0.01})
    tp = [_param(f"t{i}", w.shape, "zeros") for i, w in enumerate(init)]
    for p, w in zip(tp, init):
        p.set_data(w)
    tt = gluon.Trainer(tp, "adam", {"learning_rate": 0.1, "wd": 0.01})
    w64 = [w.astype("float64") for w in init]
    m64 = [np.zeros(w.shape) for w in init]
    v64 = [np.zeros(w.shape) for w in init]
    for t, x in enumerate(xs, 1):
        with jag.record():
            jy = [(p.data() * jmx.nd.array(a)).sum() for p, a in zip(jp, x)]
        jag.backward(jy)
        jt.step(2)
        with ag.record():
            ty = [(p.data() * _t(a)).sum() for p, a in zip(tp, x)]
        ag.backward(ty)
        tt.step(2)
        lr = 0.1 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        for i, a in enumerate(x):
            g = a * 0.5 + 0.01 * w64[i]
            m64[i] = 0.9 * m64[i] + 0.1 * g
            v64[i] = 0.999 * v64[i] + 0.001 * g * g
            w64[i] = w64[i] - lr * m64[i] / (np.sqrt(v64[i]) + 1e-8)
    for a, b, c in zip(tp, jp, w64):
        a = a.data().detach().numpy()
        np.testing.assert_allclose(a, c, rtol=0, atol=3e-7)
        np.testing.assert_allclose(a, b.data().asnumpy(), rtol=0, atol=1e-5)


# ------------------------------------------------------------ lr schedulers
_SCHEDULERS = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3)),
    ("FactorScheduler", dict(step=5, factor=0.9, warmup_steps=10,
                             warmup_begin_lr=0.001)),
    ("MultiFactorScheduler", dict(step=[5, 12, 30], factor=0.3)),
    ("MultiFactorScheduler", dict(step=[20, 40], factor=0.5,
                                  warmup_steps=8, warmup_mode="constant",
                                  warmup_begin_lr=0.002)),
    ("PolyScheduler", dict(max_update=40, pwr=2, final_lr=1e-4)),
    ("PolyScheduler", dict(max_update=45, pwr=1, warmup_steps=5)),
    ("CosineScheduler", dict(max_update=40, final_lr=1e-3)),
    ("CosineScheduler", dict(max_update=30, warmup_steps=6,
                             warmup_begin_lr=0.01)),
]


@pytest.mark.parametrize("name,kw", _SCHEDULERS)
def test_lr_scheduler_matches_jax_exactly(name, kw):
    """Every scheduler's lr over updates 0..49 equals JAX's exactly, called
    directly and through an optimizer's ``learning_rate``."""
    jsch = getattr(jsched, name)(base_lr=0.1, **kw)
    tsch = getattr(lr_scheduler, name)(base_lr=0.1, **kw)
    assert [tsch(n) for n in range(50)] == [jsch(n) for n in range(50)]

    jo = jopt.create("sgd", learning_rate=0.05,
                     lr_scheduler=getattr(jsched, name)(**kw))
    to = optimizer.create("sgd", learning_rate=0.05,
                          lr_scheduler=getattr(lr_scheduler, name)(**kw))
    seen = []
    for n in range(50):
        to.num_update = jo.num_update = n
        seen.append((to.learning_rate, jo.learning_rate))
        assert to._get_lrs([0]) == jo._get_lrs([0])
    assert [a for a, _ in seen] == [b for _, b in seen]


def test_trainer_takes_an_lr_scheduler():
    """``optimizer_params={"lr_scheduler": ...}`` reaches the optimizer:
    the Trainer's ``learning_rate`` follows the schedule step by step as
    JAX's does, the updates use it, and ``set_learning_rate`` is refused
    with the reference's ``UserWarning``."""
    jx = jgluon.Parameter("jx", shape=(3,))
    jx.initialize(init=jmx.init.Constant(0))
    jt = jgluon.Trainer([jx], "sgd", {
        "learning_rate": 0.5,
        "lr_scheduler": jsched.FactorScheduler(step=2, factor=0.5)})
    x = _param("x", (3,), "zeros")
    tt = gluon.Trainer([x], "sgd", {
        "learning_rate": 0.5,
        "lr_scheduler": lr_scheduler.FactorScheduler(step=2, factor=0.5)})
    assert tt._optimizer.lr_scheduler.base_lr == 0.5
    for _ in range(6):
        with jag.record():
            jy = jx.data() * 1.0
        jag.backward(jy)
        jt.step(1)
        with ag.record():
            ty = x.data() * 1.0
        ag.backward(ty)
        tt.step(1)
        assert tt.learning_rate == jt.learning_rate
        np.testing.assert_allclose(x.data().detach().numpy(),
                                   jx.data().asnumpy(), rtol=0, atol=ATOL)
    with pytest.raises(UserWarning, match="LRScheduler"):
        tt.set_learning_rate(0.1)
    with pytest.raises(UserWarning, match="LRScheduler"):
        jt.set_learning_rate(0.1)


# ------------------------------------------------------- Dense activations
@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_dense_activation_matches_jax(act):
    """``Dense(activation=...)`` for every ``Activation`` type against the
    JAX ``Dense`` with the same weights (atol 1e-6, O(1) values); an
    unknown name raises."""
    rng = np.random.RandomState(8)
    x = rng.randn(4, 5).astype("float32") * 2
    jd = jgluon.nn.Dense(3, activation=act, in_units=5)
    jd.initialize()
    w, b = jd.weight.data().asnumpy(), rng.randn(3).astype("float32")
    jd.bias.set_data(jmx.nd.array(b))
    td = gluon.nn.Dense(3, activation=act, in_units=5, device="cpu")
    with torch.no_grad():
        td.weight.copy_(_t(w))
        td.bias.copy_(_t(b))
        out = td(_t(x))
    np.testing.assert_allclose(out.numpy(), jd(jmx.nd.array(x)).asnumpy(),
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="unknown activation"):
        gluon.nn.Dense(3, activation="nosuch", in_units=5, device="cpu")


def test_dropped_block_is_freed_without_the_collector():
    """A block's tensors hold their gluon Parameters and a Parameter holds
    its block's tensor weakly: with the cyclic collector off, deleting the
    block, its Trainer and its Adam states frees the weights at once.  A
    Parameter of the freed block raises on use; on a live block the
    Trainer and Adam work as before."""
    import gc
    import weakref
    net = get_model("resnet18_v1", classes=10, device="cpu")
    net.initialize()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 32, 32)
                         .astype("float32"))
    net(x)
    params = net.collect_params()
    trainer = gluon.Trainer(params, "adam", {"learning_rate": 1e-3})
    start = net.features[0].weight.detach().clone()
    gc.disable()
    try:
        for _ in range(2):
            with ag.record():
                loss = net(x).sum()
            ag.backward(loss)
            trainer.step(2)
        weight = net.features[0].weight
        assert params["features.0.weight"].data() is weight
        assert trainer._updater.states         # Adam's states exist
        moved = weight.detach().clone()
        alive = [weakref.ref(t) for t in (weight, next(iter(
            trainer._updater.states.values()))[0])]
        some = params["features.0.weight"]
        del net, weight, trainer, params, loss
        assert [r() for r in alive] == [None, None]
    finally:
        gc.enable()
    with pytest.raises(RuntimeError, match="has been freed"):
        some.data()
    assert torch.isfinite(moved).all() and not torch.equal(moved, start)
