"""The port's BERT (mxnet_tpu_torch.models.bert) against the JAX package's.

A 2-layer model (units 128, 2 heads, vocab 100, T=128) is built and
initialised by the JAX package; its weights are carried into the port
through mxnet_tpu_torch.convert, and both run the same numpy inputs.
Tolerance atol/rtol 1e-4: both compute in fp32, but the erf in GELU and the
LayerNorm and softmax reductions are evaluated in a different order, and the
differences compound through two post-LN layers.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models.bert import BERTClassifier as JaxClassifier
from mxnet_tpu.models.bert import get_bert_model as jax_bert

from mxnet_tpu_torch.convert import bert_state_dict_from_gluon
from mxnet_tpu_torch.models import bert as tbert

TOL = 1e-4
T = 128


def _pair(dropout=0.0, **kw):
    """(jax net, port net) with the same weights."""
    net = jax_bert("bert_tiny", vocab_size=100, max_length=T,
                   dropout=dropout, **kw)
    net.initialize()
    x = mx.nd.array(np.zeros((1, T)), dtype="int32")
    net(x, x, None, mx.nd.array(np.zeros((1, 1)), dtype="int32"))  # shapes
    params = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    port = tbert.get_bert_model("bert_tiny", vocab_size=100, max_length=T,
                                dropout=dropout, device="cpu", **kw)
    port.load_state_dict(bert_state_dict_from_gluon(params, net.prefix))
    return net, port.eval()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 100, (2, T)).astype("int32")
    segments = rng.randint(0, 2, (2, T)).astype("int32")
    mask = np.ones((2, T), "float32")
    mask[0, 100:] = 0
    mask[1, 37:] = 0
    return tokens, segments, mask


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("route", ["flash", "dense"])
def test_bert_matches_jax(route):
    """No mask takes the flash route, a valid_mask the dense one; the
    decoder and NSP heads ride along (masked-LM gather, tied weights)."""
    net, port = _pair(use_decoder=True, use_classifier=True)
    tokens, segments, mask = _inputs()
    positions = np.array([[0, 5, 127], [3, 3, 64]], "int32")
    m = mask if route == "dense" else None
    ref = net(mx.nd.array(tokens, dtype="int32"),
              mx.nd.array(segments, dtype="int32"),
              None if m is None else mx.nd.array(m),
              mx.nd.array(positions, dtype="int32"))
    with torch.inference_mode():
        out = port(torch.from_numpy(tokens), torch.from_numpy(segments),
                   None if m is None else torch.from_numpy(m),
                   torch.from_numpy(positions))
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        _close(o.numpy(), r.asnumpy())


def test_routes_follow_the_reference(monkeypatch):
    """Flash only when unmasked AND built with dropout 0 (bert.py:57): a
    model built with dropout 0.1 stays dense even at inference."""
    calls = []
    real = tbert.contrib.flash_attention
    monkeypatch.setattr(tbert.contrib, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tokens, segments, mask = _inputs()
    for dropout, m, expect in [(0.0, None, 2), (0.0, mask, 0),
                               (0.1, None, 0)]:
        calls.clear()
        net, port = _pair(dropout=dropout, use_decoder=False,
                          use_classifier=False)
        ref = net(mx.nd.array(tokens, dtype="int32"),
                  mx.nd.array(segments, dtype="int32"),
                  None if m is None else mx.nd.array(m))
        with torch.inference_mode():
            out = port(torch.from_numpy(tokens), torch.from_numpy(segments),
                       None if m is None else torch.from_numpy(m))
        assert len(calls) == expect       # one call per layer on the flash route
        for o, r in zip(out, ref):
            _close(o.numpy(), r.asnumpy())


def test_classifier_matches_jax():
    net, port = _pair(use_decoder=False, use_classifier=False)
    jc = JaxClassifier(net, num_classes=3, dropout=0.1)
    jc.classifier.initialize()
    tokens, segments, _ = _inputs()
    ref = jc(mx.nd.array(tokens, dtype="int32"),
             mx.nd.array(segments, dtype="int32"))
    tc = tbert.BERTClassifier(port, num_classes=3, dropout=0.1).eval()
    dense = [p for k, p in jc.collect_params().items()
             if k.startswith(jc.prefix)]
    with torch.no_grad():
        tc.classifier[1].weight.tensor().copy_(torch.tensor(
            dense[0].data().asnumpy()))
        tc.classifier[1].bias.tensor().copy_(torch.tensor(
            dense[1].data().asnumpy()))
        out = tc(torch.from_numpy(tokens), torch.from_numpy(segments))
    _close(out.numpy(), ref.asnumpy())


def test_convert_rejects_unknown_names():
    with pytest.raises(KeyError, match="prefix"):
        bert_state_dict_from_gluon({"other_w": np.zeros(1)}, "bertmodel0_")
    with pytest.raises(KeyError, match="no port parameter"):
        bert_state_dict_from_gluon({"bertmodel0_mystery_weight":
                                    np.zeros(1)}, "bertmodel0_")


def test_initialize_is_seeded_and_follows_mxnet_defaults():
    def build(seed):
        net = tbert.get_bert_model("bert_tiny", vocab_size=100,
                                   max_length=T, device="cpu")
        net.initialize(generator=torch.Generator().manual_seed(seed))
        return net.state_dict()

    a, b, c = build(0), build(0), build(1)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["encoder.layers.0.attention.qkv.weight"]
    assert not torch.equal(w, c["encoder.layers.0.attention.qkv.weight"])
    assert w.abs().max() <= 0.07 and w.std() > 0.03     # U(-0.07, 0.07)
    assert torch.all(a["embed_norm.gamma"] == 1)
    assert torch.all(a["embed_norm.beta"] == 0)
    assert torch.all(a["pooler.bias"] == 0)
