"""The repo's Gluon-style examples through the port on the CPU, each read
with ``mxnet_tpu`` as ``mxnet_tpu_torch`` (the example files are not
edited) and cut to its net and one training step.

For each script: its own builder (a function or a ``HybridBlock`` class of
the script; where the script builds the net inline in ``main``, the same
lines with the script's classes) makes the net in both packages, whose
``collect_params()`` names must be equal; the JAX net's values are carried
into the port's by name; the example's loss on one batch of the
example's own synthetic data, and its gradients, must agree within 1e-5
(fp32, the same few layers in both packages); then the port takes the
example's optimizer step and its parameters must move and stay finite.
"""
import types
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5


def _load(rel, pkg):
    """The example's module, as written (the JAX package) or with
    ``mxnet_tpu`` read as ``mxnet_tpu_torch`` (the port)."""
    path = ROOT / rel
    src = path.read_text()
    if pkg is mx:
        src = src.replace("mxnet_tpu", "mxnet_tpu_torch")
    mod = types.ModuleType(path.stem)
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


# ----------------------------------------------------------------- specs
# each: (script, build(mod, pkg) -> net, batch(mod, pkg) -> (inputs,
# label), loss name, optimizer, its arguments)
def _mnist_batch(mod, pkg):
    train, _ = mod.load_data(str(ROOT / "build" / "no-mnist-here"), 16)
    batch = next(iter(train))
    return [batch.data[0].asnumpy()], batch.label[0].asnumpy()


def _finetune_batch(mod, pkg):
    x, y = mod.make_data(n=64)
    return [x.asnumpy()[:32]], y.asnumpy()[:32]


def _sd_net(mod, pkg):
    gluon = pkg.gluon
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Conv2D(8, 3, padding=1, activation="relu"))
        for i in range(2):
            net.add(mod.SDResBlock(8, 1.0 - (i + 1) / 2 * 0.5))
        net.add(gluon.nn.MaxPool2D(2, 2), gluon.nn.Dense(4))
    return net


def _blobs(n, shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n)
    protos = rng.rand(classes, *shape).astype("float32")
    x = protos[y] + 0.3 * rng.randn(n, *shape).astype("float32")
    return x.astype("float32"), y.astype("float32")


def _adversary_net(mod, pkg):
    gluon = pkg.gluon
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(4))
    return net


def _adversary_batch(mod, pkg):
    rng = np.random.RandomState(0)
    protos = (rng.rand(4, 8, 8) > 0.5).astype("float32")
    x, y = mod.synth_digits(rng, 16, protos)
    return [x], y


def _ae_batch(mod, pkg):
    x, _ = mod.make_data(n=64)
    clean = x.asnumpy()[:16]
    noisy = clean + 0.2 * np.random.RandomState(1).randn(*clean.shape)
    return [noisy.astype("float32")], clean


def _text_batch(mod, pkg):
    x, y = mod.synth(np.random.RandomState(0), 16)
    return [x], y


def _mf_batch(mod, pkg):
    rng = np.random.RandomState(0)
    users = rng.randint(0, 30, 32).astype("int32")
    items = rng.randint(0, 20, 32).astype("int32")
    return [users, items], rng.randn(32).astype("float32")


SPECS = {
    "mnist": ("example/gluon/mnist.py",
              lambda m, p: m.build_net("lenet"), _mnist_batch,
              "SoftmaxCrossEntropyLoss", "sgd",
              {"learning_rate": 0.02, "momentum": 0.9}),
    "finetune_amp": ("example/amp/finetune_amp.py",
                     lambda m, p: m.build_net(), _finetune_batch,
                     "SoftmaxCrossEntropyLoss", "sgd",
                     {"learning_rate": 0.3}),
    "sd_resnet": ("example/stochastic-depth/sd_resnet.py", _sd_net,
                  lambda m, p: ([_blobs(16, (1, 8, 8), 4)[0]],
                                _blobs(16, (1, 8, 8), 4)[1]),
                  "SoftmaxCrossEntropyLoss", "adam",
                  {"learning_rate": 0.01}),
    "adversary": ("example/adversary/adversary_generation.py",
                  _adversary_net, _adversary_batch,
                  "SoftmaxCrossEntropyLoss", "adam",
                  {"learning_rate": 0.01}),
    "denoising_ae": ("example/autoencoder/denoising_ae.py",
                     lambda m, p: m.DenoisingAE(dim=32), _ae_batch,
                     "L2Loss", "adam", {"learning_rate": 2e-3}),
    "text_cnn": ("example/cnn_text_classification/text_cnn.py",
                 lambda m, p: m.TextCNN(m.VOCAB, embed=16, classes=3),
                 _text_batch, "SoftmaxCrossEntropyLoss", "adam",
                 {"learning_rate": 0.005}),
    "matrix_fact": ("example/recommenders/matrix_fact.py",
                    lambda m, p: m.MFNet(30, 20, 8), _mf_batch, "L2Loss",
                    "adam", {"learning_rate": 0.02, "wd": 1e-5}),
}


def _arrays(pkg, inputs):
    return [pkg.nd.array(a, dtype=a.dtype if a.dtype.kind == "i"
                         else None) for a in inputs]


def _loss_and_grads(pkg, net, inputs, label, loss_name, train_mode):
    """The example's loss on one batch, its input gradients and every
    parameter gradient."""
    arrays = _arrays(pkg, inputs)
    for a in arrays:
        if a.dtype == np.float32:
            a.attach_grad()
    loss_fn = getattr(pkg.gluon.loss, loss_name)()
    with pkg.autograd.record(train_mode=train_mode):
        loss = loss_fn(net(*arrays), pkg.nd.array(label)).mean()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return (float(loss.asscalar()),
            [a.grad.asnumpy() for a in arrays if a.dtype == np.float32],
            grads)


@pytest.mark.parametrize("name", list(SPECS))
def test_example_net_and_one_step_through_the_port(name):
    """The example's net: names equal to the JAX package's; loss, input
    and parameter gradients from the JAX net's values equal (atol 1e-5;
    ``sd_resnet``'s random gates held off by predict mode); one step of
    the example's optimizer moves the port's parameters, finite."""
    script, build, batch, loss_name, opt, kw = SPECS[name]
    pmod, jmod = _load(script, mx), _load(script, jmx)
    with jmx.name.NameManager():
        jnet = build(jmod, jmx)
    with mx.name.NameManager():
        pnet = build(pmod, mx)
    assert list(pnet.collect_params()) == list(jnet.collect_params())
    inputs, label = batch(pmod, mx)
    jnet.initialize()
    pnet.initialize()
    jnet(*_arrays(jmx, inputs))           # the deferred shapes
    pnet(*_arrays(mx, inputs))
    jparams, pparams = jnet.collect_params(), pnet.collect_params()
    for k, p in pparams.items():
        p.set_data(jparams[k].data().asnumpy())
    train_mode = name != "sd_resnet"
    jl, jin, jg = _loss_and_grads(jmx, jnet, inputs, label, loss_name,
                                  train_mode)
    pl, pin, pg = _loss_and_grads(mx, pnet, inputs, label, loss_name,
                                  train_mode)
    assert abs(pl - jl) <= ATOL * max(1.0, abs(jl)), (pl, jl)
    for a, b in zip(pin, jin):
        np.testing.assert_allclose(a, b, atol=ATOL)
    assert sorted(pg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], atol=ATOL, err_msg=k)
    before = {k: p.data().asnumpy() for k, p in pparams.items()}
    trainer = mx.gluon.Trainer(pparams, opt, dict(kw))
    loss_fn = getattr(mx.gluon.loss, loss_name)()
    with mx.autograd.record():
        loss = loss_fn(pnet(*_arrays(mx, inputs)), mx.nd.array(label))
    loss.backward()
    trainer.step(len(label))
    after = {k: p.data().asnumpy() for k, p in pparams.items()}
    assert all(np.isfinite(v).all() for v in after.values())
    assert any(not np.array_equal(after[k], before[k]) for k in after)


def test_finetune_amp_example_steps_under_amp():
    """``finetune_amp.py``'s AMP phase, one step through its own ``train``
    with ``amp.init`` (bf16), ``init_trainer`` and ``scale_loss``, on the
    port: finite loss, moved parameters, fp32 master weights."""
    mod = _load("example/amp/finetune_amp.py", mx)
    x, y = mod.make_data(n=64)
    net = mod.build_net()
    net.initialize()
    net(x[:32])
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    before = [p.data().asnumpy() for p in net.collect_params().values()]
    mod.amp.init(target_dtype="bfloat16")
    try:
        mod.amp.init_trainer(trainer)
        mod.train(net, trainer, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                  x[:32], y[:32], 1, use_amp=True)
    finally:
        mod.amp.deinit()
    after = [p.data() for p in net.collect_params().values()]
    assert all(a.dtype == np.float32 and np.isfinite(a.asnumpy()).all()
               for a in after)
    assert any(not np.array_equal(a.asnumpy(), b)
               for a, b in zip(after, before))


def test_neural_style_example_image_step_through_the_port():
    """``nstyle.py``: its extractor (``make_extractor``), ``features`` and
    ``gram`` in both packages from the JAX extractor's values; the content
    and style loss of one image and its gradient with respect to the
    image agree (atol 1e-5 of the gradient's max), and the port's Adam
    step on the image moves it."""
    pmod = _load("example/neural-style/nstyle.py", mx)
    jmod = _load("example/neural-style/nstyle.py", jmx)
    with jmx.name.NameManager():
        jnet = jmod.make_extractor(jmx.cpu())
    with mx.name.NameManager():
        pnet = pmod.make_extractor(mx.cpu())
    rng = np.random.RandomState(0)
    content = rng.rand(1, 3, 16, 16).astype("float32")
    style = rng.rand(1, 3, 16, 16).astype("float32")
    start = (content + 0.3 * rng.randn(*content.shape)).astype("float32")
    jnet(jmx.nd.array(content))              # the deferred shapes
    pnet(mx.nd.array(content))
    jparams, pparams = jnet.collect_params(), pnet.collect_params()
    assert list(pparams) == list(jparams)
    for k, p in pparams.items():
        p.set_data(jparams[k].data().asnumpy())
        assert p.grad_req == "null"

    def loss_and_grad(pkg, mod, net):
        with pkg.autograd.pause():
            c_feats = mod.features(net, pkg.nd.array(content))
            s_grams = [mod.gram(f) for f in
                       mod.features(net, pkg.nd.array(style))]
        img = pkg.nd.array(start)
        img.attach_grad()
        with pkg.autograd.record():
            feats = mod.features(net, img)
            closs = sum(((f - cf) ** 2).mean()
                        for f, cf in zip(feats, c_feats))
            sloss = sum(((mod.gram(f) - sg) ** 2).mean()
                        for f, sg in zip(feats, s_grams))
            loss = closs + 50.0 * sloss
        loss.backward()
        return float(loss.asscalar()), img

    jl, jimg = loss_and_grad(jmx, jmod, jnet)
    pl, pimg = loss_and_grad(mx, pmod, pnet)
    assert abs(pl - jl) <= ATOL * max(1.0, abs(jl))
    jg = jimg.grad.asnumpy()
    np.testing.assert_allclose(pimg.grad.asnumpy(), jg,
                               atol=ATOL * np.abs(jg).max())
    m = mx.nd.zeros_like(pimg)
    m[:] = 0.1 * pimg.grad
    pimg[:] = pimg - 0.05 * m / (mx.nd.sqrt(m * m) + 1e-8)
    assert not np.array_equal(pimg.asnumpy(), start)
