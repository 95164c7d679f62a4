"""The port's Gluon losses and ``CTCLoss`` op against the JAX package's, on
the CPU.

Every loss of ``mxnet_tpu/gluon/loss.py`` the training slice had not
ported: values and the gradients with respect to every float input
(ones as head gradients, ``jax.vjp``'s counterpart through the JAX
package's autograd) within 1e-5 (O(1) values, fp32), from the same numpy
inputs, with ``weight``, ``sample_weight`` and ``batch_axis``.  Then the
loss half of ``tests/test_loss_optimizer_numerics.py``: the formulas
against numpy, in the port.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype="float32"))


def _run(name, kwargs, inputs, grad_of):
    """Per-sample losses and input gradients of both packages; a None
    input stays None."""
    jin = [None if a is None else jmx.nd.array(a) for a in inputs]
    for k in grad_of:
        jin[k].attach_grad()
    with jag.record():
        jl = getattr(jgluon.loss, name)(**kwargs)(*jin)
    jl.backward()
    tin = [None if a is None else _t(a) for a in inputs]
    for k in grad_of:
        ag.mark_variables(tin[k], torch.zeros_like(tin[k]))
    with ag.record():
        tl = getattr(gluon.loss, name)(**kwargs)(*tin)
    ag.backward(tl)
    return ((tl.detach().numpy(), jl.asnumpy()),
            [(tin[k].grad.numpy(), jin[k].grad.asnumpy()) for k in grad_of])


def _pm1(rng, shape):
    return np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype("float32")


def _inputs(kind, rng, shape):
    """(inputs, indices of the float inputs to differentiate)."""
    pred = rng.randn(*shape).astype("float32")
    if kind == "binary":
        return [pred, (rng.rand(*shape) > 0.5).astype("float32")], [0]
    if kind == "prob":
        p = rng.uniform(0.05, 0.95, shape).astype("float32")
        return [p, (rng.rand(*shape) > 0.5).astype("float32")], [0]
    if kind == "dist":
        lab = rng.dirichlet(np.ones(shape[-1]), shape[:-1]) \
            .astype("float32")
        return [pred, lab], [0]
    if kind == "logdist":
        lp = np.log(rng.dirichlet(np.ones(shape[-1]), shape[:-1])) \
            .astype("float32")
        lab = rng.dirichlet(np.ones(shape[-1]), shape[:-1]) \
            .astype("float32")
        return [lp, lab], [0]
    if kind == "signed":
        return [pred, _pm1(rng, shape)], [0]
    if kind == "regress":
        return [pred, rng.randn(*shape).astype("float32") * 2], [0]
    if kind == "triplet":
        return [pred, rng.randn(*shape).astype("float32"),
                rng.randn(*shape).astype("float32")], [0, 1, 2]
    if kind == "poisson":
        return [pred, rng.poisson(2.0, shape).astype("float32")], [0]
    if kind == "poisson_rate":
        return [rng.uniform(0.5, 3.0, shape).astype("float32"),
                rng.poisson(2.0, shape).astype("float32") + 1], [0]
    if kind == "cosine":
        return [pred, rng.randn(*shape).astype("float32"),
                _pm1(rng, shape[:1])], [0, 1]
    raise ValueError(kind)


CASES = [
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary", (4, 3), None),
    ("SigmoidBinaryCrossEntropyLoss", {"weight": 0.5}, "binary", (4, 3),
     (4, 1)),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob",
     (4, 3), None),
    ("SigmoidBinaryCrossEntropyLoss", {"batch_axis": 1}, "binary", (3, 4),
     None),
    ("SigmoidBCELoss", {}, "binary", (2, 3, 2), (2, 1, 1)),
    ("KLDivLoss", {}, "logdist", (4, 5), None),
    ("KLDivLoss", {"from_logits": False}, "dist", (4, 5), (4, 1)),
    ("KLDivLoss", {"from_logits": False, "axis": 1, "batch_axis": 1},
     "dist", (3, 4), None),
    ("HuberLoss", {}, "regress", (4, 3), None),
    ("HuberLoss", {"rho": 0.5, "weight": 2.0}, "regress", (4, 3), (4, 1)),
    ("HingeLoss", {}, "signed", (5, 3), None),
    ("HingeLoss", {"margin": 0.5, "batch_axis": 1}, "signed", (3, 5),
     None),
    ("SquaredHingeLoss", {}, "signed", (5, 3), (5, 1)),
    ("SquaredHingeLoss", {"margin": 2.0, "weight": 0.5}, "signed", (5, 3),
     None),
    ("LogisticLoss", {}, "signed", (5, 3), None),
    ("LogisticLoss", {"label_format": "binary"}, "binary", (5, 3), (5, 1)),
    ("TripletLoss", {}, "triplet", (4, 6), None),
    ("TripletLoss", {"margin": 3.0, "weight": 0.5}, "triplet", (4, 3, 2),
     None),
    ("PoissonNLLLoss", {}, "poisson", (4, 3), None),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     "poisson_rate", (4, 3), (4, 1)),
    ("CosineEmbeddingLoss", {}, "cosine", (4, 6), None),
    ("CosineEmbeddingLoss", {"margin": 0.2, "weight": 2.0}, "cosine",
     (4, 6), (4, 1)),
]


@pytest.mark.parametrize("name,kwargs,kind,shape,sw", CASES)
def test_loss_and_gradients_match_jax(name, kwargs, kind, shape, sw):
    rng = np.random.RandomState(0)
    inputs, grad_of = _inputs(kind, rng, shape)
    if sw is not None:
        inputs.append(rng.rand(*sw).astype("float32"))
    (tl, jl), grads = _run(name, kwargs, inputs, grad_of)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    for tg, jg in grads:
        np.testing.assert_allclose(tg, jg, rtol=0, atol=ATOL)


def test_bce_pos_weight_matches_jax():
    rng = np.random.RandomState(1)
    inputs, _ = _inputs("binary", rng, (4, 3))
    pw = rng.uniform(0.5, 3.0, (1, 3)).astype("float32")
    for from_sigmoid in (False, True):
        if from_sigmoid:
            inputs[0] = rng.uniform(0.05, 0.95, (4, 3)).astype("float32")
        (tl, jl), grads = _run("SigmoidBinaryCrossEntropyLoss",
                               {"from_sigmoid": from_sigmoid},
                               inputs + [None, pw], [0])
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
        np.testing.assert_allclose(*grads[0], rtol=0, atol=ATOL)


def _ctc_data(rng, t=12, n=3, c=6, lab_len=4, pad=-1):
    data = rng.randn(t, n, c).astype("float32")
    lengths = [4, 2, 3]
    label = np.full((n, lab_len), pad, "float32")
    for i, k in enumerate(lengths):
        label[i, :k] = rng.randint(0, c - 1, k)
    return data, label, np.array(lengths, "float32")


@pytest.mark.parametrize("layout,label_layout,use_lengths", [
    ("TNC", "NT", False), ("NTC", "NT", False), ("NTC", "TN", True),
    ("TNC", "NT", True)])
def test_ctc_loss_block_matches_jax(layout, label_layout, use_lengths):
    """``gluon.loss.CTCLoss`` (blank last, labels padded with -1) with and
    without ``pred_lengths``/``label_lengths``, losses and the gradient
    with respect to the scores."""
    rng = np.random.RandomState(2)
    data, label, lab_len = _ctc_data(rng)
    if layout == "NTC":
        data = data.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    inputs = [data, label]
    if use_lengths:
        inputs += [np.array([12, 9, 10], "float32"), lab_len]
    (tl, jl), grads = _run("CTCLoss", {"layout": layout,
                                       "label_layout": label_layout},
                           inputs, [0])
    assert tl.shape == (3,)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    np.testing.assert_allclose(*grads[0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("attrs", [
    dict(), dict(blank_label="last"),
    dict(use_data_lengths=True, use_label_lengths=True),
    dict(use_label_lengths=True, blank_label="last")])
def test_ctc_loss_op_matches_jax(attrs):
    """``mx.nd.CTCLoss`` under the op's own conventions: blank first (0,
    padding 0) or last (padding -1), the optional length inputs."""
    rng = np.random.RandomState(3)
    last = attrs.get("blank_label") == "last"
    data, label, lab_len = _ctc_data(rng, pad=-1 if last else 0)
    if not last:
        label = np.where(label > 0, label, 0) + (label > 0)
    inputs = [data, label]
    if attrs.get("use_data_lengths"):
        inputs.append(np.array([12, 7, 11], "float32"))
    if attrs.get("use_label_lengths"):
        inputs.append(lab_len)
    jd = jmx.nd.array(data)
    jd.attach_grad()
    with jag.record():
        jl = jmx.nd.CTCLoss(jd, *[jmx.nd.array(a) for a in inputs[1:]],
                            **attrs)
    jl.backward()
    td = mx.nd.array(data, ctx=mx.cpu())
    td.attach_grad()
    with mx.autograd.record():
        tl = mx.nd.CTCLoss(td, *[mx.nd.array(a, ctx=mx.cpu())
                                 for a in inputs[1:]], **attrs)
    tl.backward()
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), rtol=0,
                               atol=1e-5 * np.abs(jl.asnumpy()).max())
    np.testing.assert_allclose(td.grad.asnumpy(), jd.grad.asnumpy(), rtol=0,
                               atol=ATOL)


# ------------------------------------- the loss half of the JAX numerics
rng = np.random.RandomState(7)


def _loss(name, *arrays, **kwargs):
    return getattr(gluon.loss, name)(**kwargs)(
        *[_t(a) for a in arrays]).detach().numpy()


def test_sigmoid_bce_loss_formula():
    pred = rng.randn(6, 3).astype("float32")
    label = (rng.rand(6, 3) > 0.5).astype("float32")
    ref = (np.maximum(pred, 0) - pred * label
           + np.log1p(np.exp(-np.abs(pred)))).mean(axis=1)
    np.testing.assert_allclose(
        _loss("SigmoidBinaryCrossEntropyLoss", pred, label), ref, rtol=1e-5)


def test_huber_loss_formula():
    out = _loss("HuberLoss", [[0.0, 2.0]], [[0.5, 0.0]], rho=1.0)
    np.testing.assert_allclose(out, [(0.5 * 0.25 + 1.5) / 2], rtol=1e-5)


def test_kl_div_loss_formula():
    pred = rng.rand(4, 6).astype("float32")
    label = rng.rand(4, 6).astype("float32")
    label /= label.sum(axis=1, keepdims=True)
    out = _loss("KLDivLoss", pred, label, from_logits=False)
    logp = pred - np.log(np.exp(pred).sum(axis=1, keepdims=True))
    ref = (label * (np.log(label + 1e-12) - logp)).mean(axis=1)
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_hinge_and_squared_hinge():
    pred = np.array([[0.5], [-0.3], [2.0]], "float32")
    label = np.array([[1], [1], [-1]], "float32")
    np.testing.assert_allclose(
        _loss("HingeLoss", pred, label),
        np.maximum(0, 1 - label * pred).mean(axis=1), rtol=1e-5)
    np.testing.assert_allclose(
        _loss("SquaredHingeLoss", pred, label),
        (np.maximum(0, 1 - label * pred) ** 2).mean(axis=1), rtol=1e-5)


def test_logistic_loss_label_formats():
    pred = np.array([[0.3], [-0.7]], "float32")
    lab_pm1 = np.array([[1], [-1]], "float32")
    np.testing.assert_allclose(
        _loss("LogisticLoss", pred, lab_pm1, label_format="signed"),
        np.log1p(np.exp(-lab_pm1 * pred)).mean(axis=1), rtol=1e-5)
    lab01 = np.array([[1], [0]], "float32")
    np.testing.assert_allclose(
        _loss("LogisticLoss", pred, lab01, label_format="binary"),
        np.log1p(np.exp(-(2 * lab01 - 1) * pred)).mean(axis=1), rtol=1e-5)
    with pytest.raises(ValueError, match="signed or binary"):
        gluon.loss.LogisticLoss(label_format="other")


def test_triplet_loss_formula():
    r = np.random.RandomState(0)
    a, p, n = [r.randn(4, 6).astype("float32") for _ in range(3)]
    want = np.maximum(((a - p) ** 2).sum(1) - ((a - n) ** 2).sum(1) + 1.0,
                      0)
    np.testing.assert_allclose(_loss("TripletLoss", a, p, n, margin=1.0),
                               want, rtol=1e-4, atol=1e-5)


def test_poisson_nll_loss_formula():
    pred = np.array([[0.5, 1.2], [0.1, 2.0]], "float32")
    target = np.array([[1.0, 2.0], [0.0, 3.0]], "float32")
    out = _loss("PoissonNLLLoss", pred, target, from_logits=False)
    np.testing.assert_allclose(out, (pred - target * np.log(pred + 1e-8))
                               .mean(), rtol=1e-4)


def test_cosine_embedding_loss_formula():
    r = np.random.RandomState(1)
    x1 = r.randn(3, 5).astype("float32")
    x2 = r.randn(3, 5).astype("float32")
    lab = np.array([1, -1, 1], "float32")
    out = _loss("CosineEmbeddingLoss", x1, x2, lab, margin=0.1)
    cos = (x1 * x2).sum(1) / (np.linalg.norm(x1, axis=1)
                              * np.linalg.norm(x2, axis=1) + 1e-12)
    want = np.where(lab == 1, 1 - cos, np.maximum(0, cos - 0.1))
    np.testing.assert_allclose(out.ravel(), want, rtol=1e-4, atol=1e-5)


def test_ctc_loss_matches_simple_case():
    """Two steps, three classes, blank last, target [1]: the paths (b, 1),
    (1, b) and (1, 1)."""
    logits = np.log(np.array([[[0.6, 0.3, 0.1]], [[0.2, 0.7, 0.1]]],
                             "float32"))
    out = _loss("CTCLoss", logits, [[1]], layout="TNC")
    p = 0.1 * 0.7 + 0.3 * 0.1 + 0.3 * 0.7
    np.testing.assert_allclose(out, [-np.log(p)], rtol=1e-4)
    with pytest.raises(ValueError, match="layouts for pred"):
        gluon.loss.CTCLoss(layout="NCT")
