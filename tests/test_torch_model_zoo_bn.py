"""The zoo's BatchNorm families (MobileNet V1 and V2, Inception-v3)
against the JAX package, on the CPU.

Inference logits at batch 1 from seeded weights carried JAX -> port only
through a ``.params`` file, within 1e-4 of the largest logit: MobileNet
0.25 and MobileNet V2 0.25 at 64x64 (depthwise and grouped convolutions,
ReLU6 as ``clip``, the inverted residual), Inception-v3 at its 299x299
((1, 7) and (7, 1) kernels, four-way concatenations, 94 BatchNorms).
Then three SGD-momentum steps of MobileNet V2 0.25 at (4, 3, 64, 64) in
training mode, every BatchNorm on batch statistics, held to the JAX
package's under ``tests/test_torch_train.py``'s rule: per quantity (each
step's losses, the step-1 gradients, the parameters and running
statistics after step 3), the largest error relative to each tensor's
max within 1e-4, or twice the JAX package's own spread under two
reorderings of the batch if that is larger.

The JAX package's side of MobileNet V2 (its seeding, logits and the
three training runs) runs in a fresh process (this file run as a
script), started with the module and run beside its first tests: the
JAX package's eager dispatch compiles op by op, and in a test worker
that had run other JAX tests the same runs took 84 s instead of ~25.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon.model_zoo import get_model, vision
from mxnet_tpu_torch.test_utils import structural_params

from test_torch_model_zoo import hold_logits, hold_logits_to, seeded_jax_net

OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
STEPS = 3


def _bn_count(net):
    return sum(isinstance(m, gluon.nn.BatchNorm) for m in net.modules())


ORDERS = ([0, 1, 2, 3], [2, 0, 3, 1], [1, 3, 0, 2])


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randn(4, 3, 64, 64).astype("float32"),
            rng.randint(0, 10, 4).astype("float32"))


def _jax_mobilenet_v2(out):
    """The JAX side, in this file's own process: the seeded MobileNet V2
    0.25 (a forward at batch 1 fixes its shapes), its logits and
    ``.params`` file, and three training runs, one per order of
    ``ORDERS``, into ``out/jax.npz`` (keys ``run|quantity|name``)."""
    x1 = np.random.RandomState(6).randn(1, 3, 64, 64).astype("float32")
    jnet = seeded_jax_net(lambda: jvision.get_model("mobilenetv2_0.25",
                                                    classes=10), x1)
    flat = {"x1": x1, "logits": jnet(jmx.nd.array(x1)).asnumpy()}
    jnet.save_parameters(str(out / "w.params"))
    x, y = _batch()
    for r, order in enumerate(ORDERS):
        losses, grads, params = _train_jax(str(out / "w.params"), x, y,
                                           np.array(order))
        flat.update({f"{r}|loss|{i}": v for i, v in enumerate(losses)})
        flat.update({f"{r}|grad|{k}": v for k, v in grads.items()})
        flat.update({f"{r}|param|{k}": v for k, v in params.items()})
    np.savez(out / "jax.npz", **flat)


@pytest.fixture(scope="module", autouse=True)
def jax_mobilenet_v2_process(tmp_path_factory):
    """Starts :func:`_jax_mobilenet_v2` in a fresh process when the module
    starts, so that it runs beside the module's first tests; stops it if
    it is still running when the module ends."""
    out = tmp_path_factory.mktemp("mobilenet_v2")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + (":" + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], cwd=root,
                            env=env)
    try:
        yield out, proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)


@pytest.fixture(scope="module")
def mobilenet_v2(jax_mobilenet_v2_process):
    """The JAX MobileNet V2 0.25's input, logits, ``.params`` file and
    training runs, once its process is done."""
    out, proc = jax_mobilenet_v2_process
    assert proc.wait(timeout=900) == 0
    with np.load(out / "jax.npz") as z:
        data = {k: z[k] for k in z.files}
    runs = []
    for r in range(len(ORDERS)):
        pick = {q: {k.split("|", 2)[2]: v for k, v in data.items()
                    if k.startswith(f"{r}|{q}|")}
                for q in ("loss", "grad", "param")}
        runs.append(([pick["loss"][str(i)] for i in range(STEPS)],
                     pick["grad"], pick["param"]))
    return data["x1"], data["logits"], out / "w.params", runs


@pytest.mark.parametrize("name, hw, bns", [("mobilenet0.25", 64, 27),
                                           ("inceptionv3", 299, 94),
                                           ("mobilenetv2_0.25", 64, 53)])
def test_logits_match_jax_through_params_file(name, hw, bns, request,
                                              tmp_path):
    with mx.name.NameManager():
        port = get_model(name, classes=10, device="cpu")
    if name == "mobilenetv2_0.25":
        x, ref, path, _ = request.getfixturevalue("mobilenet_v2")
        hold_logits_to(ref, port, x, path)
    else:
        x = np.random.RandomState(6).randn(1, 3, hw, hw).astype("float32")
        jnet = seeded_jax_net(lambda: jvision.get_model(name, classes=10),
                              x)
        hold_logits(jnet, port, x, tmp_path / "w.params")
    assert _bn_count(port) == bns


def _train_jax(path, x, y, perm):
    """Three steps of the JAX package on the batch in the order ``perm``:
    per-sample losses (in the original order), step-1 gradients, final
    parameters and running statistics by structural name."""
    with jmx.name.NameManager():
        net = jvision.get_model("mobilenetv2_0.25", classes=10)
    net.load_parameters(path)
    params = net._collect_params_with_prefix()
    trainer = jgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
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


def _train_port(path, x, y):
    with mx.name.NameManager():
        net = get_model("mobilenetv2_0.25", classes=10, device="cpu")
    net.load_parameters(path)
    params = structural_params(net)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses, grads = [], None
    for step in range(STEPS):
        with ag.record():
            loss = loss_fn(net(xt), yt)
        ag.backward(loss)
        losses.append(loss.detach().numpy())
        if step == 0:
            grads = {k: p.grad_tensor().clone().numpy()
                     for k, p in params.items() if p.grad_req != "null"}
        trainer.step(len(x))
    return losses, grads, {k: p.tensor().detach().numpy().copy()
                           for k, p in params.items()}


def _rel(a, b):
    keys = sorted(b)
    assert sorted(a) == keys and keys
    return max(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)
               for k in keys)


def test_mobilenet_v2_training_steps_match_jax(mobilenet_v2):
    """Three SGD steps (lr 0.01, momentum 0.9, wd 1e-4) from the same
    seeded weights: 53 BatchNorms on batch statistics (the last ones over
    2x2 maps, 16 values a channel at batch 4), the depthwise convolutions'
    and ReLU6's gradients, the inverted residuals' sums."""
    _, _, path, (ref, *others) = mobilenet_v2
    port = _train_port(str(path), *_batch())

    def check(what, pick):
        spread = max(_rel(pick(o), pick(ref)) for o in others)
        tol = max(1e-4, 2 * spread)
        err = _rel(pick(port), pick(ref))
        assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"

    for step in range(STEPS):
        assert np.isfinite(port[0][step]).all()
        check(f"loss of step {step + 1}", lambda r: {"l": r[0][step]})
    check("step-1 gradients", lambda r: r[1])
    check("parameters and running statistics after step 3", lambda r: r[2])
    assert port[0][-1].mean() < port[0][0].mean()


@pytest.mark.parametrize("fn", [vision.alexnet, vision.vgg16_bn,
                                vision.squeezenet1_1, vision.densenet121,
                                vision.inception_v3, vision.mobilenet0_5,
                                vision.mobilenet_v2_1_0])
def test_pretrained_raises(fn):
    """No weights are downloaded: ``pretrained=True`` raises, as in the
    JAX package."""
    with pytest.raises(NotImplementedError, match="pretrained"):
        fn(pretrained=True, device="cpu")


if __name__ == "__main__":
    _jax_mobilenet_v2(Path(sys.argv[1]))
