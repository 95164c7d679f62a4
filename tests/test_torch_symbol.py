"""``mx.sym`` in the port against the JAX package, on the CPU (the cases of
``tests/test_symbol.py`` and ``tests/test_symbol_api.py`` run by both).

Graph construction, listings, auto-names, ``infer_shape`` and
``infer_type`` must be identical (exact).  Graph JSON crosses in both
directions: what one package's ``tojson`` writes, the other's
``load_json`` reads, and the two forwards of the loaded graph on the same
seeded inputs agree within 1e-5 of the output's largest magnitude (fp32,
summation order only).  A JAX gluon ``resnet18_v1`` exported at
(2, 3, 32, 32) loads into the port from its ``-symbol.json`` and
``.params`` files and gives the JAX block's logits within 1e-5 of their
largest magnitude.
"""
import json
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu.symbol import symbol as jax_symbol

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.symbol import symbol as port_symbol
from chip_smoke import resnet_v1_symbol

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_names(monkeypatch):
    """Unnamed nodes take ``<op>N`` from a process-wide counter per op in
    each package; fresh counters in both make the names independent of the
    tests run before in the same process."""
    monkeypatch.setattr(jax_symbol, "_NAME_COUNTER", {})
    monkeypatch.setattr(port_symbol, "_NAME_COUNTER", {})


def _mlp(sym):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=16)
    act = sym.Activation(fc1, name="act1", act_type="relu")
    fc2 = sym.FullyConnected(act, name="fc2", num_hidden=4)
    return sym.SoftmaxOutput(fc2, name="softmax")


def _conv_bn(sym):
    data = sym.Variable("data")
    c = sym.Convolution(data, num_filter=6, kernel=(3, 3), pad=(1, 1),
                        name="conv1")
    b = sym.BatchNorm(c, name="bn1", fix_gamma=False)
    p = sym.Pooling(sym.Activation(b, act_type="relu", name="relu1"),
                    kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool1")
    f = sym.FullyConnected(sym.Flatten(p, name="flat"), num_hidden=5,
                           name="fc")
    return sym.SoftmaxOutput(f, name="softmax")


def _resnet(sym):
    return resnet_v1_symbol(sym, [1, 1], [8, 16, 32], 10)


def _multi(sym):
    """Two heads, a split and scalar arithmetic."""
    x = sym.Variable("x")
    y = sym.Variable("y")
    parts = sym.split(x * 2.0 + y, num_outputs=2, axis=1, name="sp")
    return sym.Group([sym.broadcast_mul(parts[0], parts[1], name="mul"),
                      sym.sum(sym.exp(x - 1.0, name="e"), axis=1,
                              name="s")])


GRAPHS = {"mlp": (_mlp, {"data": (4, 6)}),
          "conv_bn": (_conv_bn, {"data": (2, 3, 8, 8)}),
          "resnet": (_resnet, {"data": (2, 3, 32, 32)}),
          "multi": (_multi, {"x": (3, 4), "y": (3, 4)})}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_listings_and_inference_match_jax(graph):
    build, shapes = GRAPHS[graph]
    j, p = build(jmx.sym), build(mx.sym)
    assert p.list_arguments() == j.list_arguments()
    assert p.list_auxiliary_states() == j.list_auxiliary_states()
    assert p.list_outputs() == j.list_outputs()
    assert p.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert p.infer_shape(**shapes) == j.infer_shape(**shapes)
    assert p.infer_type(**{k: "float32" for k in shapes}) == \
        j.infer_type(**{k: "float32" for k in shapes})
    assert p.attr_dict() == j.attr_dict()


def test_auto_names_match_jax():
    """Unnamed nodes take ``<op>N`` from a counter per op, in both
    packages."""

    def build(sym):
        x = sym.Variable("data")
        h = sym.Activation(sym.FullyConnected(x, num_hidden=8),
                           act_type="tanh")
        h = sym.BatchNorm(sym.Convolution(sym.Reshape(h, shape=(0, 2, 2, 2)),
                                          num_filter=3, kernel=(1, 1)))
        h = sym.FullyConnected(h + 1.0, num_hidden=3)
        return sym.SoftmaxOutput(h)

    j, p = build(jmx.sym), build(mx.sym)
    assert p.list_arguments() == j.list_arguments()
    assert "fullyconnected1_weight" in p.list_arguments()
    assert p.list_auxiliary_states() == ["batchnorm0_moving_mean",
                                         "batchnorm0_moving_var"]
    assert [n["name"] for n in json.loads(p.tojson())["nodes"]] == \
        [n["name"] for n in json.loads(j.tojson())["nodes"]]
    assert p.tojson() == j.tojson()


def _inputs(sym, shapes, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: rng.randn(*s).astype("float32") * 0.5
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    if "softmax_label" in args:
        args["softmax_label"] = rng.randint(
            0, 4, args["softmax_label"].shape).astype("float32")
    auxs = {n: (rng.rand(*s) + 0.5 if n.endswith("var") else rng.randn(*s))
            .astype("float32") for n, s in zip(sym.list_auxiliary_states(),
                                                aux_shapes)}
    return args, auxs


def _jax_forward(sym, args, auxs, is_train=False):
    ex = sym.bind(jmx.cpu(), args={k: jmx.nd.array(v)
                                   for k, v in args.items()},
                  aux_states={k: jmx.nd.array(v) for k, v in auxs.items()},
                  grad_req="null")
    return [o.asnumpy() for o in ex.forward(is_train=is_train)]


def _port_forward(sym, args, auxs, is_train=False):
    ex = sym.bind(mx.cpu(), args={k: mx.nd.array(v, ctx=mx.cpu())
                                  for k, v in args.items()},
                  aux_states={k: mx.nd.array(v, ctx=mx.cpu())
                              for k, v in auxs.items()},
                  grad_req="null")
    return [o.asnumpy() for o in ex.forward(is_train=is_train)]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("is_train", [False, True])
def test_json_from_jax_runs_in_port(graph, is_train):
    build, shapes = GRAPHS[graph]
    j = build(jmx.sym)
    p = mx.sym.load_json(j.tojson())
    assert p.tojson() == j.tojson()
    args, auxs = _inputs(j, shapes)
    _close(_port_forward(p, args, auxs, is_train),
           _jax_forward(j, args, auxs, is_train))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_json_from_port_runs_in_jax(graph):
    build, shapes = GRAPHS[graph]
    p = build(mx.sym)
    j = jmx.sym.load_json(p.tojson())
    assert j.tojson() == p.tojson()
    args, auxs = _inputs(p, shapes)
    _close(_jax_forward(j, args, auxs), _port_forward(p, args, auxs))


def test_json_round_trip_is_bitwise(tmp_path):
    p = _resnet(mx.sym)
    p.save(str(tmp_path / "net-symbol.json"))
    q = mx.sym.load(str(tmp_path / "net-symbol.json"))
    assert q.tojson() == p.tojson()
    args, auxs = _inputs(p, {"data": (2, 3, 32, 32)})
    for a, b in zip(_port_forward(q, args, auxs, True),
                    _port_forward(p, args, auxs, True)):
        np.testing.assert_array_equal(a, b)
    r = pickle.loads(pickle.dumps(p))
    assert r.tojson() == p.tojson()


def test_jax_exported_resnet18_loads_into_port(tmp_path):
    jmx.random.seed(3)
    net = jax_vision.resnet18_v1(classes=10)
    net.initialize()
    net.hybridize()
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype("float32")
    want = net(jmx.nd.array(x)).asnumpy()
    net.export(str(tmp_path / "r18"), epoch=0)
    sym = mx.sym.load(str(tmp_path / "r18-symbol.json"))
    params = mx.nd.load(str(tmp_path / "r18-0000.params"))
    args = {k[4:]: v for k, v in params.items() if k.startswith("arg:")}
    auxs = {k[4:]: v for k, v in params.items() if k.startswith("aux:")}
    assert sorted(args) == sorted(a for a in sym.list_arguments()
                                  if a != "data")
    assert sorted(auxs) == sorted(sym.list_auxiliary_states())
    args["data"] = mx.nd.array(x, ctx=mx.cpu())
    ex = sym.bind(mx.cpu(), args=args, aux_states=auxs, grad_req="null")
    got = ex.forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_compose_group_and_indexing_match_jax():
    def build(sym):
        data = sym.Variable("data")
        net1 = sym.FullyConnected(data, name="fc1", num_hidden=10)
        net1 = sym.FullyConnected(net1, name="fc2", num_hidden=8)
        data2 = sym.Variable("data2")
        net2 = sym.FullyConnected(data2, name="fc3", num_hidden=6)
        composed = net2(data2=net1, name="composed")
        g = sym.Group([composed, net1])
        return composed, g

    (jc, jg), (pc, pg) = build(jmx.sym), build(mx.sym)
    assert pc.list_arguments() == jc.list_arguments()
    assert pc.list_outputs() == jc.list_outputs() == ["composed_output"]
    assert pg.list_outputs() == jg.list_outputs()
    assert pg[1].list_outputs() == jg[1].list_outputs()
    assert pg["fc2_output"].list_arguments() == \
        jg["fc2_output"].list_arguments()
    assert pc.get_children().list_outputs() == \
        jc.get_children().list_outputs()
    with pytest.raises(ValueError, match="grouped"):
        pc(data=pg)
    with pytest.raises(TypeError, match="ambiguous"):
        bool(pc)


@pytest.mark.parametrize("method,call", [
    ("reshape", lambda s: s.reshape((2, 12))),
    ("transpose", lambda s: s.transpose((1, 0, 2))),
    ("sum", lambda s: s.sum(axis=1)),
    ("mean", lambda s: s.mean(axis=2, keepdims=True)),
    ("exp", lambda s: s.exp()),
    ("sqrt", lambda s: s.sqrt()),
    ("flatten", lambda s: s.flatten()),
    ("clip", lambda s: s.clip(0.6, 1.2)),
    ("expand_dims", lambda s: s.expand_dims(axis=0)),
    ("arith", lambda s: (s * 2.0 - 1.0) / (s + 3.0) ** 2.0),
    ("rsub", lambda s: 1.0 - s),
    ("compare", lambda s: (s > 0.9) + (s <= 0.7)),
])
def test_fluent_methods_and_arithmetic_match_jax(method, call):
    x = np.random.RandomState(0).rand(2, 3, 4).astype("float32") + 0.5
    j, p = call(jmx.sym.Variable("x")), call(mx.sym.Variable("x"))
    assert p.list_arguments() == j.list_arguments() == ["x"]
    _close(_port_forward(p, {"x": x}, {}), _jax_forward(j, {"x": x}, {}))


def test_split_v2_counts_its_sections():
    """``split_v2(x, 2)`` has two outputs; the JAX package gives it one (a
    reference-side defect, ROADMAP.md), so this case runs in the port
    alone."""
    x = mx.sym.Variable("x")
    two = mx.sym.split_v2(x, 2, axis=1)
    assert len(two.list_outputs()) == 2
    three = mx.sym.split_v2(x, indices_or_sections=(1, 3), axis=1)
    assert len(three) == 3
    arr = np.arange(12, dtype="float32").reshape(2, 6)
    outs = _port_forward(three, {"x": arr}, {})
    assert [o.shape for o in outs] == [(2, 1), (2, 2), (2, 3)]


def test_infer_type_rules_match_jax():
    def build(sym):
        data = sym.Variable("data")
        h = sym.BatchNorm(sym.FullyConnected(data, num_hidden=3, name="fc"),
                          name="bn")
        idx = sym.Variable("idx")
        return sym.Group([sym.take(h, idx, name="tk"),
                          sym.one_hot(idx, depth=4, name="oh"),
                          sym.Cast(h, dtype="float16", name="c")])

    j, p = build(jmx.sym), build(mx.sym)
    for kw in ({"data": "float16"}, {"data": "float32", "idx": "int32"}):
        assert p.infer_type(**kw) == j.infer_type(**kw)
        assert p.infer_type_partial(**kw) == j.infer_type_partial(**kw)
    with pytest.raises(ValueError, match="matches no variable"):
        p.infer_type(nope="float32")


def test_infer_shape_partial_and_errors_match_jax():
    def build(sym):
        return sym.FullyConnected(sym.Variable("data") + sym.Variable("b"),
                                  num_hidden=4, name="fc")

    j, p = build(jmx.sym), build(mx.sym)
    assert p.infer_shape() == j.infer_shape() == (None, None, None)
    assert p.infer_shape_partial(data=(2, 3)) == \
        j.infer_shape_partial(data=(2, 3))
    with pytest.raises(ValueError, match="cannot infer shapes"):
        p.simple_bind(ctx=mx.cpu())


def test_legacy_json_gets_batchnorm_aux_states():
    """A pre-1.0 graph (``param`` attributes, 2-element inputs, BatchNorm
    without its auxiliary inputs) loads as in the JAX package."""
    legacy = json.dumps({
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "null", "name": "bn_gamma", "inputs": []},
            {"op": "null", "name": "bn_beta", "inputs": []},
            {"op": "BatchNorm", "name": "bn", "param": {"eps": "0.001"},
             "inputs": [[0, 0], [1, 0], [2, 0]]}],
        "arg_nodes": [0, 1, 2], "heads": [[3, 0]]})
    j, p = jmx.sym.load_json(legacy), mx.sym.load_json(legacy)
    assert p.list_auxiliary_states() == j.list_auxiliary_states() == \
        ["bn_moving_mean", "bn_moving_var"]
    assert p.list_arguments() == j.list_arguments()
    assert p.infer_shape(data=(2, 3)) == j.infer_shape(data=(2, 3))


def test_variable_attributes_match_jax():
    def build(sym):
        w = sym.Variable("w", shape=(4, 3), dtype="float16", lr_mult=0.5,
                         wd_mult=0.0, init="zeros", attr={"tag": "x"})
        return sym.FullyConnected(sym.Variable("data"), weight=w,
                                  num_hidden=4, no_bias=True, name="fc")

    j, p = build(jmx.sym), build(mx.sym)
    assert p.tojson() == j.tojson()
    assert p.attr_dict() == j.attr_dict()
    assert p.list_arguments() == j.list_arguments()
