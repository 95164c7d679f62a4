"""BERT pretraining (masked LM + next sentence) in the port against the JAX
package, on the CPU: ``tests/test_bert.py:61-86``'s case run by both.

``bert_tiny`` (2 layers, 128 units, 2 heads), vocab 64, T=128, batch 4, 4
masked positions, ``dropout=0.0``, MXNet's loop in both packages
(``autograd.record``, ``SoftmaxCrossEntropyLoss``, ``backward``,
``Trainer.step`` with ``"adam"`` at lr 1e-3).  The JAX package initialises
the weights; ``convert.bert_state_dict_from_gluon`` carries them across.
Two routes: no mask (the flash route; JAX runs its Pallas kernel in
interpret mode at T=128) and a padded ``valid_mask`` (the dense route).
The flash route is also driven through ``mx.nd`` NDArrays, as
``example/bert/pretrain.py`` writes it: bitwise the port's tensor path on
the CPU, and within the tolerances below of the JAX package.

Tolerances, fp32 throughout:
- the losses of the 3 steps and every step-1 gradient within 1e-4 of the
  tensor's largest magnitude (measured: 1e-5 and 2e-6; the two packages
  differ in summation order only);
- every parameter after 3 steps within 1e-4 of the tensor's largest
  magnitude, plus what Adam makes of the two packages' gradient
  disagreement.  Adam's step ``lr * m / sqrt(v)`` is scale-free in the
  gradient: where the gradients of steps 1..s part by a fraction R_s of
  JAX's, the step-s moves may part by about 2 R_s lr, and by 2 lr once
  R_s >= 1, where the gradient is rounding noise (the key bias of each
  attention layer, zero in exact arithmetic).  The elements that need this
  allowance (past 1e-4 of their tensor's largest) are counted by kind:
  key-bias elements (the middle third of each layer's ``qkv.bias``) are
  not capped, since each run's gradient there is rounding noise; at most
  8 others.  Measured over JAX initialisations from ``mx.random.seed``
  0-15 on both routes: 0 to 30 key-bias elements (30 at seed 1 on the
  flash route, 18 at seed 13 on the dense one) and 0 to 3 others; the
  others sit in tensors that start at zero (biases and LayerNorm betas,
  whose largest element, which scales the tolerance, is itself a few lr
  after 3 steps), except one element of ``decoder_transform.weight`` at
  seed 5 (flash), whose gradient is 3% of its tensor's largest.  The
  fixture seeds the JAX initialisation (seed 0), so that the weights do
  not depend on which tests ran before in the same process.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import get_bert_model as jax_bert

import mxnet_tpu_torch as mx_port
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.convert import bert_state_dict_from_gluon
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.ops import flash_attention as fa

V, T, B, M = 64, 128, 4, 4
LR, STEPS, TOL = 1e-3, 3, 1e-4


def _batch(route):
    """Tokens from the first half of the vocabulary only, so that the rows
    of the second half take their gradient from the tied masked-LM decoder
    alone; labels over the whole vocabulary."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, V // 2, (B, T)).astype("int32")
    segments = rng.randint(0, 2, (B, T)).astype("int32")
    mask = (rng.rand(B, T) > 0.1).astype("float32")
    positions = rng.randint(0, T, (B, M)).astype("int32")
    rng = np.random.RandomState(1)
    mlm = rng.randint(0, V, (B, M)).astype("float32")
    nsp = rng.randint(0, 2, (B,)).astype("float32")
    return tokens, segments, mask if route == "dense" else None, positions, \
        mlm, nsp


@pytest.fixture(scope="module")
def jax_net():
    mx.random.seed(0)
    net = jax_bert("bert_tiny", vocab_size=V, max_length=T, dropout=0.0)
    net.initialize()
    x = mx.nd.array(np.zeros((1, T)), dtype="int32")
    net(x, x, None, mx.nd.array(np.zeros((1, 1)), dtype="int32"))  # shapes
    init = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    names = {k: next(iter(bert_state_dict_from_gluon({k: v}, net.prefix)))
             for k, v in init.items()}
    return net, init, names


def _train_jax(jax_net, route):
    net, init, names = jax_net
    params = net.collect_params()
    for k, p in params.items():
        p.set_data(mx.nd.array(init[k]))
    tok, seg, mask, pos, mlm_y, nsp_y = _batch(route)
    args = (mx.nd.array(tok, dtype="int32"), mx.nd.array(seg, dtype="int32"),
            None if mask is None else mx.nd.array(mask),
            mx.nd.array(pos, dtype="int32"))
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": LR})
    losses, grads = [], []
    for _ in range(STEPS):
        with mx.autograd.record():
            _, _, mlm, nsp = net(*args)
            loss = sce(mlm.reshape((-1, V)),
                       mx.nd.array(mlm_y).reshape((-1,))).mean() + \
                sce(nsp, mx.nd.array(nsp_y)).mean()
        loss.backward()
        grads.append({names[k]: p.grad().asnumpy().copy()
                      for k, p in params.items()})
        trainer.step(B)
        losses.append(float(loss.asscalar()))
    return losses, grads, {names[k]: p.data().asnumpy()
                           for k, p in params.items()}


def _port_model(jax_net):
    net, init, _ = jax_net
    port = tbert.get_bert_model("bert_tiny", vocab_size=V, max_length=T,
                                dropout=0.0, device="cpu")
    port.load_state_dict(bert_state_dict_from_gluon(init, net.prefix))
    return port


def _train_port(port, batch, steps, vocab=V):
    tok, seg, mask, pos, mlm_y, nsp_y = (None if a is None else
                                         torch.from_numpy(a) for a in batch)
    params = port.collect_params()
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "adam", {"learning_rate": LR})
    losses, grads = [], []
    for _ in range(steps):
        with ag.record():
            _, _, mlm, nsp = port(tok, seg, mask, pos)
            loss = sce(mlm.reshape(-1, vocab), mlm_y.reshape(-1)).mean() + \
                sce(nsp, nsp_y).mean()
        ag.backward(loss)
        grads.append({k: p.grad().numpy().copy() for k, p in params.items()
                      if p.grad_req != "null"})
        trainer.step(tok.shape[0])
        losses.append(float(loss.detach()))
    return losses, grads, {k: p.data().detach().numpy().copy()
                           for k, p in params.items()}


@pytest.fixture(scope="module")
def jax_runs(jax_net):
    """The JAX package's 3 steps on each route, run once per module."""
    runs = {}

    def get(route):
        if route not in runs:
            runs[route] = _train_jax(jax_net, route)
        return runs[route]
    return get


def _check_against_jax(jax_run, port_run):
    """The tolerances of the module docstring."""
    jl, jg, jp = jax_run
    pl, pg, pp = port_run
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=0)
    assert pl[-1] < pl[0]
    assert sorted(pg[0]) == sorted(jg[0]) == sorted(pp)
    for k, ref in jg[0].items():
        np.testing.assert_allclose(pg[0][k], ref, rtol=0,
                                   atol=TOL * np.abs(ref).max(), err_msg=k)

    # the tied word embedding takes the decoder's share: rows of tokens the
    # batch does not hold get a gradient in both packages, and the same one
    emb = "word_embed.weight"
    assert np.abs(jg[0][emb][V // 2:]).min(axis=1).max() > 0
    assert np.abs(jg[0][emb][V // 2:]).max() > 0.1 * np.abs(jg[0][emb]).max()

    # Adam's allowance per element: 2 lr R_s a step, R_s the largest
    # fraction apart of the two packages' gradients up to step s
    allow, worst = {}, {}
    for g, h in zip(jg, pg):
        for k, r in g.items():
            with np.errstate(divide="ignore", invalid="ignore"):
                frac = np.nan_to_num(np.abs(h[k] - r) / np.abs(r), nan=0.0,
                                     posinf=1.0)
            worst[k] = np.maximum(worst.get(k, 0.0), np.minimum(frac, 1.0))
            allow[k] = allow.get(k, 0.0) + 2 * LR * worst[k]
    others = {}
    for k, ref in jp.items():
        diff = np.abs(pp[k] - ref)
        scale = TOL * np.abs(ref).max()
        assert (diff <= scale + allow[k]).all(), \
            (k, (diff - scale - allow[k]).max())
        past = diff > scale
        if k.endswith("attention.qkv.bias"):
            past[ref.shape[0] // 3:2 * ref.shape[0] // 3] = False
        if past.any():
            others[k] = int(past.sum())
    assert sum(others.values()) <= 8, others


@pytest.mark.parametrize("route", ["flash", "dense"])
def test_pretraining_steps_match_jax(jax_net, jax_runs, route):
    """Three Adam steps of MLM+NSP, both packages, same weights and batch
    (tolerances in the module docstring)."""
    port = _port_model(jax_net)
    before = fa.flash_attention.backward_calls
    run = _train_port(port, _batch(route), STEPS)
    # the flash route's gradient is the port's own backward: one call per
    # layer and step; the dense route never reaches it
    assert fa.flash_attention.backward_calls - before == \
        (2 * STEPS if route == "flash" else 0)
    _check_against_jax(jax_runs(route), run)


def _train_port_nd(port, batch, steps):
    """``_train_port`` written as ``example/bert/pretrain.py`` writes it:
    NDArray inputs made with ``mx.nd.array(..., ctx=...)``, NDArray outputs
    from the blocks, ``loss.backward()``, ``loss.wait_to_read()`` and
    ``loss.asscalar()``."""
    ctx = mx_port.cpu()
    tok, seg, mask, pos, mlm_y, nsp_y = batch
    tok, seg, pos = (mx_port.nd.array(a, dtype="int32", ctx=ctx)
                     for a in (tok, seg, pos))
    mask = None if mask is None else mx_port.nd.array(mask, ctx=ctx)
    mlm_y, nsp_y = (mx_port.nd.array(a, ctx=ctx) for a in (mlm_y, nsp_y))
    port.initialize(init=_keep, ctx=ctx)
    params = port.collect_params()
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "adam", {"learning_rate": LR})
    losses, grads = [], []
    for _ in range(steps):
        with mx_port.autograd.record():
            _, _, mlm, nsp = port(tok, seg, mask, pos)
            loss = sce(mlm.reshape((-1, V)), mlm_y.reshape((-1,))).mean() + \
                sce(nsp, nsp_y).mean()
        assert isinstance(loss, mx_port.nd.NDArray)
        loss.backward()
        grads.append({k: p.grad().numpy().copy() for k, p in params.items()
                      if p.grad_req != "null"})
        trainer.step(tok.shape[0])
        loss.wait_to_read()
        losses.append(float(loss.asscalar()))
    return losses, grads, {k: p.data().detach().numpy().copy()
                           for k, p in params.items()}


def _keep(name, tensor, generator=None):
    """An initializer that leaves the loaded weights as they are."""


def test_pretraining_through_ndarrays(jax_net, jax_runs):
    """The flash route driven through NDArrays: bitwise the port's tensor
    path on the CPU (the same torch operations; the NDArray layer adds a
    copy of each reshaped view, which changes no value), and the JAX
    package's steps within this module's tolerances."""
    batch = _batch("flash")
    before = fa.flash_attention.backward_calls
    nd_run = _train_port_nd(_port_model(jax_net), batch, STEPS)
    assert fa.flash_attention.backward_calls - before == 2 * STEPS
    tensor_run = _train_port(_port_model(jax_net), batch, STEPS)
    assert nd_run[0] == tensor_run[0]
    for got, want in zip(nd_run[1] + [nd_run[2]],
                         tensor_run[1] + [tensor_run[2]]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _check_against_jax(jax_runs("flash"), nd_run)


def test_port_pretraining_converges():
    """``tests/test_bert.py:61-86`` in the port alone: 15 Adam steps on a
    fixed batch (T=12 with a valid mask, the dense route) bring the MLM+NSP
    loss below 0.8 of its first value."""
    vocab, t, b, masked = 64, 12, 4, 4
    port = tbert.get_bert_model("bert_tiny", vocab_size=vocab, max_length=32,
                                dropout=0.0, device="cpu")
    port.initialize(generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, vocab, (b, t)).astype("int32")
    segments = rng.randint(0, 2, (b, t)).astype("int32")
    mask = (rng.rand(b, t) > 0.1).astype("float32")
    positions = rng.randint(0, t, (b, masked)).astype("int32")
    rng = np.random.RandomState(1)
    batch = (tokens, segments, mask, positions,
             rng.randint(0, vocab, (b, masked)).astype("float32"),
             rng.randint(0, 2, (b,)).astype("float32"))
    losses = _train_port(port, batch, 15, vocab)[0]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_decoder_bias_starts_at_zero():
    """``decoder_bias`` initialises to zeros, as the reference's
    ``init="zeros"`` does (``mxnet_tpu/models/bert.py:200-201``)."""
    port = tbert.get_bert_model("bert_tiny", vocab_size=V, max_length=T,
                                device="cpu")
    port.initialize(generator=torch.Generator().manual_seed(0))
    assert not port.decoder_bias.any()
