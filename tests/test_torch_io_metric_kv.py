"""``mx.io``, ``mx.metric`` and the local ``mx.kv`` in the port against the
JAX package, on the CPU.

- ``NDArrayIter``: batches, ``provide_data``/``provide_label``, ``'pad'``
  and ``'discard'`` against the JAX iterator (exact); ``'roll_over'``
  against MXNet 1.5's documented behaviour (the JAX package's differs, see
  ROADMAP.md's reference-side defects); shuffling keeps data and labels
  paired; ``ResizeIter``.
- Every metric of ``metric.py`` on the same seeded numpy predictions in
  both packages: equal within 1e-6 relative (the same numpy code on the
  host; only float32 sums of NDArray inputs may round apart).
- The ``local``/``device`` KVStore against the JAX one on
  ``tests/test_kvstore.py``'s single-process cases, and a store-side SGD
  optimizer over several pushes within 1e-6 of each tensor's largest
  magnitude.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _epochs(it, n=3):
    out = []
    for _ in range(n):
        out.append([(b.data[0].asnumpy().tolist(),
                     b.label[0].asnumpy().tolist(), b.pad) for b in it])
        it.reset()
    return out


@pytest.mark.parametrize("handle", ["pad", "discard"])
@pytest.mark.parametrize("batch", [3, 4, 5])
def test_ndarray_iter_matches_jax(handle, batch):
    x = np.arange(20, dtype="float32").reshape(10, 2)
    y = np.arange(10, dtype="float32")
    p = mx.io.NDArrayIter(x, y, batch_size=batch, last_batch_handle=handle)
    j = jmx.io.NDArrayIter(x, y, batch_size=batch, last_batch_handle=handle)
    assert _epochs(p) == _epochs(j)
    assert [tuple(d) for d in p.provide_data] == \
        [tuple(d) for d in j.provide_data] == [("data", (batch, 2))]
    assert [tuple(d) for d in p.provide_label] == \
        [tuple(d) for d in j.provide_label]


def test_ndarray_iter_roll_over_carries_the_last_batch():
    """MXNet 1.5: the incomplete last batch is not returned; the next epoch
    starts with its rows followed by the first rows of the data, ``pad``
    counting the rows carried over."""
    x = np.arange(10, dtype="float32").reshape(10, 1)
    it = mx.io.NDArrayIter(x, np.arange(10), batch_size=4,
                           last_batch_handle="roll_over")
    e1, e2, e3 = _epochs(it)
    assert [d for d, _, _ in e1] == [[[0], [1], [2], [3]],
                                     [[4], [5], [6], [7]]]
    assert [(np.ravel(d).tolist(), p) for d, _, p in e2] == \
        [([8, 9, 0, 1], 2), ([2, 3, 4, 5], 0), ([6, 7, 8, 9], 0)]
    assert [np.ravel(d).tolist() for d, _, _ in e3] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(np.ravel(d).tolist() == lab for e in (e1, e2, e3)
               for d, lab, _ in e)


def test_ndarray_iter_shuffle_dict_inputs_and_resize():
    np.random.seed(0)
    x = np.arange(24, dtype="float32").reshape(12, 2)
    it = mx.io.NDArrayIter({"a": x, "b": x * 10}, {"lab": x[:, 0]},
                           batch_size=4, shuffle=True)
    assert [d.name for d in it.provide_data] == ["a", "b"]
    seen = []
    for b in it:
        a, bb = (d.asnumpy() for d in b.data)
        np.testing.assert_array_equal(bb, a * 10)
        np.testing.assert_array_equal(b.label[0].asnumpy(), a[:, 0])
        assert b.data[0].context == mx.cpu()
        seen += a[:, 0].tolist()
    assert sorted(seen) == x[:, 0].tolist() and seen != x[:, 0].tolist()
    r = mx.io.ResizeIter(mx.io.NDArrayIter(x, batch_size=5), 5)
    assert [b.pad for b in r] == [0, 0, 3, 0, 0]
    with pytest.raises(ValueError, match="last_batch_handle"):
        mx.io.NDArrayIter(x, batch_size=4, last_batch_handle="wrap")


def _preds(rng, n=12, k=4):
    logits = rng.randn(n, k).astype("float32")
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return prob.astype("float32"), rng.randint(0, k, n).astype("float32")


METRICS = {
    "acc": lambda m: m.create("acc"),
    "top_k_acc": lambda m: m.create("top_k_acc", top_k=3),
    "ce": lambda m: m.create("ce"),
    "nll_loss": lambda m: m.create("nll_loss"),
    "perplexity": lambda m: m.Perplexity(ignore_label=2),
    "loss": lambda m: m.Loss(),
    "torch": lambda m: m.Torch(),
    "caffe": lambda m: m.Caffe(),
    "composite": lambda m: m.create(["acc", "ce", "mse"]),
    "custom": lambda m: m.create(lambda l, p: float((p.argmax(1) == l)
                                                    .mean())),
    "np": lambda m: m.np(lambda l, p: (float(np.abs(p).sum()), 2)),
}
BINARY = {
    "f1": lambda m: m.F1(),
    "f1_micro": lambda m: m.F1(average="micro"),
    "mcc": lambda m: m.MCC(),
    "mcc_micro": lambda m: m.MCC(average="micro"),
    "pcc": lambda m: m.PCC(),
}
REGRESSION = {"mae": lambda m: m.MAE(), "mse": lambda m: m.MSE(),
              "rmse": lambda m: m.RMSE(),
              "pearsonr": lambda m: m.PearsonCorrelation()}


def _run_metric(pkg, make, batches, global_too=True):
    m = make(pkg.metric)
    for i, (label, pred) in enumerate(batches):
        m.update([pkg.nd.array(label, ctx=pkg.cpu())],
                 [pkg.nd.array(pred, ctx=pkg.cpu())])
        if i == 1 and global_too:
            m.reset_local()
    got = [m.get_name_value()]
    if global_too:
        got.append(m.get_global_name_value()
                   if not isinstance(m, pkg.metric.CompositeEvalMetric)
                   else None)
    return got


def _same(got, want):
    for g, w in zip(got, want):
        if w is None:
            continue
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_classification_metrics_match_jax(name):
    rng = np.random.RandomState(len(name))
    batches = [(lab, pred) for pred, lab in (_preds(rng) for _ in range(3))]
    global_too = name != "composite"      # see test_composite_metric_...
    _same(_run_metric(mx, METRICS[name], batches, global_too),
          _run_metric(jmx, METRICS[name], batches, global_too))


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_metrics_match_jax(name):
    rng = np.random.RandomState(len(name))
    batches = [(lab, pred) for pred, lab in (_preds(rng, 16, 2)
                                             for _ in range(3))]
    _same(_run_metric(mx, BINARY[name], batches),
          _run_metric(jmx, BINARY[name], batches))


@pytest.mark.parametrize("name", sorted(REGRESSION))
def test_regression_metrics_match_jax(name):
    rng = np.random.RandomState(len(name))
    batches = [(rng.randn(8).astype("float32"),
                rng.randn(8).astype("float32")) for _ in range(3)]
    _same(_run_metric(mx, REGRESSION[name], batches),
          _run_metric(jmx, REGRESSION[name], batches))


def test_composite_metric_resets_locally_and_reads_globally():
    """The port's composite has MXNet 1.5's ``reset_local`` and
    ``get_global``, which ``Speedometer(auto_reset=True)`` calls; the JAX
    package's lacks them (ROADMAP.md, reference-side defects), so this
    runs in the port alone, against its children."""
    rng = np.random.RandomState(0)
    comp = mx.metric.create(["acc", "ce"])
    acc, ce = mx.metric.create("acc"), mx.metric.create("ce")
    for i in range(3):
        pred, lab = _preds(rng)
        for m in (comp, acc, ce):
            m.update([mx.nd.array(lab)], [mx.nd.array(pred)])
            if i == 1:
                m.reset_local()
    names, values = comp.get()
    assert names == ["accuracy", "cross-entropy"]
    assert values == [acc.get()[1], ce.get()[1]]
    assert comp.get_global()[1] == [acc.get_global()[1], ce.get_global()[1]]


def test_metric_configs_match_jax():
    for name in ("acc", "f1", "mcc", "pearsonr", "nll_loss", "loss", "ce",
                 "mae", "rmse", "top_k_accuracy"):
        kw = {"top_k": 2} if name.startswith("top_k") else {}
        assert mx.metric.create(name, **kw).get_config() == \
            jmx.metric.create(name, **kw).get_config()


SHAPE = (4, 4)
KEYS = [5, 7, 11]


def _kv_script(pkg, kv_type):
    """``tests/test_kvstore.py``'s single-process cases as one script;
    returns every value pulled, in order."""
    nd = pkg.nd
    got = []
    kv = pkg.kv.create(kv_type)
    kv.init(3, nd.ones(SHAPE))
    val = nd.zeros(SHAPE)
    kv.pull(3, out=val)
    got.append(val.asnumpy())
    kv.push(3, nd.ones(SHAPE) * 4)
    kv.pull(3, out=val)
    got.append(val.asnumpy())
    kv.init(KEYS, [nd.ones(SHAPE) * k for k in KEYS])
    vals = [nd.zeros(SHAPE) for _ in KEYS]
    kv.pull(KEYS, out=vals)
    got += [v.asnumpy() for v in vals]
    g = nd.ones(SHAPE)                     # the store owns its copy
    kv.push(3, g)
    g *= 5
    kv.pull(3, out=val)
    got.append(val.asnumpy())
    kv.push(3, [nd.ones(SHAPE) * 2, nd.ones(SHAPE) * 3])   # summed
    outs = [nd.zeros(SHAPE), nd.zeros(SHAPE)]
    kv.pull(3, out=outs)
    got += [o.asnumpy() for o in outs]
    kv.push(KEYS, [[nd.ones(SHAPE)] * 2 for _ in KEYS])
    kv.pull(KEYS, out=vals)
    got += [v.asnumpy() for v in vals]

    def updater(key, recv, local):
        local += recv * 2
    kv.set_updater(updater)
    kv.push(KEYS, [nd.ones(SHAPE) * 3 for _ in KEYS])
    kv.pull(KEYS, out=vals)
    got += [v.asnumpy() for v in vals]
    return got, kv


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_kvstore_cases_match_jax(kv_type):
    (p, pkv), (j, jkv) = _kv_script(mx, kv_type), _kv_script(jmx, kv_type)
    assert len(p) == len(j)
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a, b)
    assert (pkv.type, pkv.rank, pkv.num_workers) == \
        (jkv.type, jkv.rank, jkv.num_workers)


def test_kvstore_key_checks_and_str_keys():
    kv = mx.kv.create("local")
    kv.init("w", mx.nd.ones(SHAPE))
    out = mx.nd.zeros(SHAPE)
    kv.pushpull("w", mx.nd.ones(SHAPE) * 6, out=out)
    np.testing.assert_array_equal(out.asnumpy(), 6)
    with pytest.raises(TypeError, match="mixing"):
        kv.init(1, mx.nd.ones(SHAPE))
    with pytest.raises(ValueError, match="not been initialized"):
        kv.push("nope", mx.nd.ones(SHAPE))
    with pytest.raises(ValueError, match="duplicate"):
        kv.init("w", mx.nd.ones(SHAPE))
    for t in ("dist_sync", "dist_async", "nccl"):
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            mx.kv.create(t)
    with pytest.raises(ValueError, match="unknown KVStore"):
        mx.kv.create("bogus")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        kv.row_sparse_pull("w", out=out, row_ids=mx.nd.array([0]))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        kv.set_gradient_compression({"type": "2bit"})


def _optimizer_store(pkg, tmp_path=None):
    opt = pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               wd=0.01, rescale_grad=0.5)
    kv = pkg.kv.create("local")
    rng = np.random.RandomState(0)
    w = [rng.randn(*SHAPE).astype("float32") for _ in KEYS]
    kv.init(KEYS, [pkg.nd.array(v, ctx=pkg.cpu()) for v in w])
    kv.set_optimizer(opt)
    outs = [pkg.nd.zeros(SHAPE, ctx=pkg.cpu()) for _ in KEYS]
    for step in range(3):
        kv.push(KEYS, [pkg.nd.array(rng.randn(*SHAPE).astype("float32"),
                                    ctx=pkg.cpu()) for _ in KEYS])
        if step == 1 and tmp_path is not None:
            kv.save_optimizer_states(str(tmp_path / "s.states"))
    kv.pull(KEYS, out=outs)
    return [o.asnumpy() for o in outs], kv


def test_store_side_optimizer_matches_jax(tmp_path):
    (p, pkv), (j, _) = _optimizer_store(mx, tmp_path), _optimizer_store(jmx)
    for a, b in zip(p, j):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())
    states = {k: v.clone() for k, v in pkv._updater.states.items()}
    pkv.load_optimizer_states(str(tmp_path / "s.states"))
    assert sorted(pkv._updater.states) == sorted(states)
    assert all(isinstance(v, torch.Tensor)
               for v in pkv._updater.states.values())
