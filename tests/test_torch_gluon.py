"""Gluon's authoring surface in the port (``Block``, ``name_scope``,
``hybrid_forward``, ``ParameterDict``, ``export``/``SymbolBlock``, the new
layers, ``gluon.utils`` and initializers), held against the JAX package on
the CPU with the same numpy inputs; weights cross by value
(``set_data``) or through ``.params`` files, never through seeds.

Names depend on how many blocks of a kind a thread has made, as in MXNet:
every net whose names are compared is built inside a fresh
``with NameManager():`` of its own package.  Exported graph files are
compared by loading and evaluating them, never byte for byte (their node
names come from global counters).  Tolerances are stated per test: 1e-5
absolute for fp32 results of the same few operations in both packages.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.models import bert as jbert

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.models import bert as tbert

ATOL = 1e-5
NO_WD = ".*beta|.*gamma|.*bias"


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default context is the GPU; these tests ask for the
    CPU."""
    with mx.cpu():
        yield


def _np(x):
    """A port or JAX NDArray, or a tensor, as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return x.asnumpy()


def _carry(jnet, pnet):
    """Give the port net the JAX net's values, parameter by parameter
    under their (equal) prefixed names."""
    jparams, pparams = jnet.collect_params(), pnet.collect_params()
    assert list(jparams) == list(pparams)
    for k, p in pparams.items():
        p.set_data(jparams[k].data().asnumpy())


# --------------------------------------- test_gluon.py's cases, restated
def test_parameter_dict():
    params0 = gluon.ParameterDict("net_")
    params0.get("w0", shape=(10, 10))
    params0.get("w1", shape=(10, 10), stype="default")
    params0.initialize(ctx=mx.current_context())
    params1 = gluon.ParameterDict("net_")
    params1.get("w0", shape=(10, 10))
    params1.get("w1", shape=(10, 10))
    assert list(params0.keys()) == ["net_w0", "net_w1"]
    assert params0["net_w0"].data().shape == (10, 10)
    assert params0["net_w1"].list_ctx() == [mx.cpu()]
    shared = gluon.ParameterDict("other_", shared=params0)
    assert shared.get("w0") is not params0["net_w0"]      # other prefix
    same = gluon.ParameterDict("net_", shared=params0)
    assert same.get("w0") is params0["net_w0"]
    with pytest.raises(AssertionError, match="does not match"):
        params0.get("w0", shape=(3, 3))


def test_constant():
    """A constant takes no gradient and keeps its value through a
    Trainer step; the input's gradient flows past it."""
    class Test(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.value = np.asarray([[1, 2], [3, 4]])
            self.const = self.params.get_constant("const", self.value)

        def hybrid_forward(self, F, x, const):
            return x + const

    test = Test()
    test.initialize()
    trainer = gluon.Trainer(test.collect_params(), "sgd",
                            {"learning_rate": 1.0, "momentum": 0.5},
                            kvstore=None)
    with autograd.record():
        x = nd.ones((2, 2))
        x.attach_grad()
        y = test(x)
        y.backward()
    trainer.step(1)
    assert (test.const.data().asnumpy() == test.value).all()
    assert (x.grad.asnumpy() == 1).all()
    assert test.const.grad_req == "null"


def test_flatten_lambda():
    fl = nn.Flatten()
    x = nd.ones((2, 3, 4))
    assert fl(x).shape == (2, 12)
    lam = nn.HybridLambda("relu")
    assert lam(nd.array([-1.0, 1.0])).asnumpy().tolist() == [0.0, 1.0]
    lam2 = nn.Lambda(lambda x: x * 2)
    assert lam2(nd.ones((2,))).asnumpy().tolist() == [2.0, 2.0]
    lam3 = nn.HybridLambda(lambda F, x: F.relu(x) + 1)
    assert lam3(nd.array([-1.0, 1.0])).asnumpy().tolist() == [1.0, 2.0]


def test_activations():
    """``test_gluon.py``'s points, and every activation against the JAX
    layer on the same inputs (atol 1e-6)."""
    point = nd.array([-0.1, 0.1] * 3)
    swish, elu, selu, prelu, gelu = (nn.Swish(), nn.ELU(), nn.SELU(),
                                     nn.PReLU(), nn.GELU())
    for block in (swish, elu, selu, prelu, gelu):
        block.initialize()
    x = point.asnumpy()
    np.testing.assert_allclose(swish(point).asnumpy(),
                               x / (1 + np.exp(-x)), atol=1e-6)
    np.testing.assert_allclose(elu(point).asnumpy(),
                               np.where(x < 0, np.exp(x) - 1, x), atol=1e-6)
    np.testing.assert_allclose(prelu(point).asnumpy(),
                               np.where(x >= 0, x, 0.25 * x), atol=1e-6)
    rng = np.random.RandomState(1)
    data = rng.randn(3, 4, 5).astype("float32")
    for make in (lambda m: m.LeakyReLU(0.1), lambda m: m.PReLU(),
                 lambda m: m.ELU(0.7), lambda m: m.SELU(),
                 lambda m: m.Swish(1.5), lambda m: m.GELU(),
                 lambda m: m.Activation("softrelu")):
        jl, pl = make(jmx.gluon.nn), make(nn)
        jl.initialize()
        pl.initialize()
        np.testing.assert_allclose(pl(nd.array(data)).asnumpy(),
                                   jl(jmx.nd.array(data)).asnumpy(),
                                   rtol=0, atol=1e-6)


def test_sequential_indexing():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8), nn.Dense(4), nn.Dense(2))
    assert len(net) == 3
    assert isinstance(net[1], nn.Dense)
    assert len(list(iter(net))) == 3
    part = net[1:]
    assert isinstance(part, nn.HybridSequential) and len(part) == 2
    assert part.prefix == net.prefix and part[0] is net[1]


def test_block_repr_and_collect():
    net = nn.HybridSequential(prefix="model_")
    with net.name_scope():
        net.add(nn.Dense(8, in_units=4))
    params = net.collect_params()
    names = list(params.keys())
    assert all(n.startswith("model_") for n in names)
    assert "weight" in names[0]
    r = repr(net)
    assert "Dense" in r and "4 -> 8" in r
    assert list(net._collect_params_with_prefix()) == ["0.weight",
                                                       "0.bias"]


def test_clip_global_norm():
    """The norm before clipping and the arrays after it, against the JAX
    package (atol 1e-6)."""
    arrays = [nd.ones((3,)) * 2, nd.ones((2,)) * 3]
    jarrays = [jmx.nd.ones((3,)) * 2, jmx.nd.ones((2,)) * 3]
    total = gluon.utils.clip_global_norm(arrays, 1.0)
    jtotal = jmx.gluon.utils.clip_global_norm(jarrays, 1.0)
    np.testing.assert_allclose(total, jtotal, rtol=1e-6)
    norm = np.sqrt(sum((a.asnumpy() ** 2).sum() for a in arrays))
    assert norm <= 1.0 + 1e-5
    for a, b in zip(arrays, jarrays):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), atol=1e-6)


def test_split_and_load():
    ctx = [mx.current_context()]
    data = nd.arange(12).reshape((4, 3))
    splits = gluon.utils.split_and_load(data, ctx)
    assert len(splits) == 1
    assert splits[0].shape == (4, 3)
    parts = gluon.utils.split_data(nd.arange(10), 3, even_split=False)
    assert [p.shape[0] for p in parts] == [3, 3, 4]
    with pytest.raises(ValueError, match="evenly"):
        gluon.utils.split_data(nd.arange(10), 3)
    assert gluon.utils.shape_is_known((2, 3))
    assert not gluon.utils.shape_is_known((2, 0))


def test_export_symbolblock_roundtrip(tmp_path):
    """hybridize -> export -> SymbolBlock.imports serves identically
    (``mxnet_tpu/gluon/block.py:731`` export, ``:942`` imports)."""
    net = nn.HybridSequential(prefix="exp_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8),
                nn.Dense(4, in_units=16))
    net.initialize()
    with pytest.raises(RuntimeError, match="hybridize"):
        net.export(str(tmp_path / "early"))
    net.hybridize()
    x = nd.random.uniform(shape=(2, 8))
    ref = net(x).asnumpy()
    prefix = str(tmp_path / "served")
    net.export(prefix)
    served = gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0000.params")
    out = served(x).asnumpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert sorted(served.collect_params()) == sorted(net.collect_params())


# ------------------------------------------------------------ names, order
def _mlp(pkg):
    g = pkg.gluon
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Dense(8, activation="relu"), g.nn.Dropout(0.1),
                g.nn.BatchNorm(), g.nn.Dense(4))
    return net


def _bert(pkg):
    if pkg is jmx:
        return jbert.get_bert_model("bert_tiny", vocab_size=50,
                                    max_length=16, num_layers=2)
    return tbert.get_bert_model("bert_tiny", vocab_size=50, max_length=16,
                                num_layers=2, device="cpu")


NETS = {
    "resnet50_v1": lambda p: (jvision if p is jmx else _zoo).get_model(
        "resnet50_v1", **({} if p is jmx else {"device": "cpu"})),
    "resnet50_v1_nhwc": lambda p: (jvision if p is jmx else _zoo).get_model(
        "resnet50_v1", layout="NHWC",
        **({} if p is jmx else {"device": "cpu"})),
    "resnet18_v2": lambda p: (jvision if p is jmx else _zoo).get_model(
        "resnet18_v2", **({} if p is jmx else {"device": "cpu"})),
    "bert_2_layers": _bert,
    "name_scope_mlp": _mlp,
}


class _zoo:
    get_model = staticmethod(get_model)


@pytest.mark.parametrize("name", list(NETS))
def test_collect_params_names_and_trainer_order_match_jax(name):
    """``collect_params()`` gives the JAX net's names in its order, and a
    Trainer takes the parameters in the JAX Trainer's order (sorted
    names); the structural names stay the JAX net's too.  Built without a
    forward."""
    with jmx.name.NameManager():
        jnet = NETS[name](jmx)
    with mx.name.NameManager():
        pnet = NETS[name](mx)
    jparams, pparams = jnet.collect_params(), pnet.collect_params()
    assert list(pparams) == list(jparams)
    assert sorted(pnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())
    jtr = jmx.gluon.Trainer(jparams, "sgd", {"learning_rate": 0.1})
    ptr = gluon.Trainer(pparams, "sgd", {"learning_rate": 0.1})
    assert [p.name for p in ptr._params] == [p.name for p in jtr._params]
    assert {k: p.grad_req for k, p in pparams.items()} == \
        {k: p.grad_req for k, p in jparams.items()}


def test_name_scope_counters_and_prefixes():
    """Outside any scope the thread's manager counts per alias; inside a
    block's scope the block's counters do; ``prefix=""`` shares the
    enclosing scope; ``params=`` shares parameters."""
    with mx.name.NameManager():
        a, b = nn.Dense(2), nn.Dense(2)
        net = nn.HybridSequential()
        with net.name_scope():
            c = nn.Dense(2)
            body = nn.HybridSequential(prefix="")
            d = nn.Conv2D(2, 1)
            act = nn.Activation("relu")
            shared = nn.Dense(2, params=c.params)
    assert (a.prefix, b.prefix, c.prefix) == \
        ("dense0_", "dense1_", "hybridsequential0_dense0_")
    assert body.prefix == "hybridsequential0_"
    assert d.name == "hybridsequential0_conv0"
    assert act.prefix == "hybridsequential0_relu0_"
    assert shared.prefix == "hybridsequential0_dense1_"
    assert shared.params["hybridsequential0_dense0_weight"] is \
        c.params["hybridsequential0_dense0_weight"]
    assert shared.weight is c.weight            # one tensor, two blocks


# -------------------------------------------------------------- user blocks
def _user_block(pkg):
    g = pkg.gluon

    class UserBlock(g.HybridBlock):
        """``params.get``, ``get_constant``, a child layer, ``F`` ops."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.w = self.params.get("w", shape=(4, 3))
                self.b = self.params.get("b", shape=(4,), init="zeros")
                self.c = self.params.get_constant(
                    "c", [[1.0, 2.0, 0.5, -1.0]])
                self.out = g.nn.Dense(2, in_units=4)

        def hybrid_forward(self, F, x, w, b, c):
            h = F.FullyConnected(x, w, b, num_hidden=4)
            return self.out(F.tanh(h) * c)

    return UserBlock()


def test_user_hybrid_forward_block_matches_jax(tmp_path):
    """A user block's output, input gradient and parameter gradients
    against the JAX package on the same values (atol 1e-5); its names are
    the JAX block's; ``self.w`` is the ``Parameter``; it exports and
    imports."""
    with jmx.name.NameManager():
        jnet = _user_block(jmx)
    with mx.name.NameManager():
        pnet = _user_block(mx)
    jnet.initialize()
    pnet.initialize()
    _carry(jnet, pnet)
    assert isinstance(pnet.w, gluon.Parameter)
    assert pnet.w.name == "userblock0_w"
    x = np.random.RandomState(2).randn(5, 3).astype("float32")
    jx, px = jmx.nd.array(x), nd.array(x)
    jx.attach_grad()
    px.attach_grad()
    with jmx.autograd.record():
        jy = jnet(jx)
    jy.backward()
    with autograd.record():
        py = pnet(px)
    py.backward()
    assert isinstance(py, nd.NDArray)
    np.testing.assert_allclose(py.asnumpy(), jy.asnumpy(), atol=ATOL)
    np.testing.assert_allclose(px.grad.asnumpy(), jx.grad.asnumpy(),
                               atol=ATOL)
    for k, p in pnet.collect_params().items():
        if p.grad_req != "null":
            np.testing.assert_allclose(
                p.grad().asnumpy(), jnet.collect_params()[k].grad()
                .asnumpy(), atol=ATOL, err_msg=k)
    pnet.hybridize()
    pnet(px)
    files = pnet.export(str(tmp_path / "user"))
    back = gluon.SymbolBlock.imports(files[0], ["data"], files[1])
    np.testing.assert_allclose(back(px).asnumpy(), py.asnumpy(), atol=ATOL)


def test_user_block_deferred_shape_via_infer_shape():
    """A user parameter of unknown width takes its shape from the block's
    ``infer_shape`` at the first forward, as MXNet's deferred init."""
    class Scale(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.s = self.params.get("s", shape=(0,), init="ones",
                                     allow_deferred_init=True)

        def infer_shape(self, x):
            self.s.shape = (x.shape[1],)

        def hybrid_forward(self, F, x, s):
            return F.broadcast_mul(x, s.reshape((1, -1)))

    blk = Scale()
    blk.initialize()
    with pytest.raises(gluon.DeferredInitializationError):
        blk.s.data()
    out = blk(nd.ones((2, 3)))
    assert out.asnumpy().tolist() == [[1.0] * 3] * 2
    assert blk.s.shape == (3,)


def test_block_hooks_apply_summary_and_plain_block(capsys):
    """Forward hooks and pre-hooks (``detach``), ``apply``, ``summary``,
    and a plain ``Block`` whose ``forward`` takes NDArrays."""
    class Twice(gluon.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.dense = nn.Dense(3, in_units=2)

        def forward(self, x):
            assert isinstance(x, nd.NDArray)
            return self.dense(x) * 2

    net = Twice()
    net.initialize()
    seen = []
    pre = net.register_forward_pre_hook(lambda b, i: seen.append("pre"))
    post = net.register_forward_hook(lambda b, i, o: seen.append("post"))
    out = net(nd.ones((4, 2)))
    assert isinstance(out, nd.NDArray) and seen == ["pre", "post"]
    pre.detach()
    post.detach()
    net(nd.ones((4, 2)))
    assert seen == ["pre", "post"]
    names = []
    net.apply(lambda b: names.append(type(b).__name__))
    assert names == ["Dense", "Twice"]
    net.summary(nd.ones((4, 2)))
    text = capsys.readouterr().out
    assert "Total params: 9" in text and "Dense-1" in text


def test_parameterdict_save_load_and_legacy_params(tmp_path):
    """``collect_params().save`` / ``load`` by prefixed name, and
    ``save_params``/``load_params``; ``save_parameters`` keeps the
    structural names, so a JAX file of either kind loads."""
    with jmx.name.NameManager():
        jnet = _mlp(jmx)
    with mx.name.NameManager():
        pnet = _mlp(mx)
    x = np.random.RandomState(3).randn(2, 5).astype("float32")
    jnet.initialize()
    jnet(jmx.nd.array(x))
    f1, f2 = str(tmp_path / "prefixed.params"), str(tmp_path / "s.params")
    jnet.collect_params().save(f1)
    jnet.save_parameters(f2)
    pnet.collect_params().load(f1)
    ref = jnet(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(pnet(nd.array(x)).asnumpy(), ref, atol=ATOL)
    with mx.name.NameManager():
        other = _mlp(mx)
    other.load_parameters(f2)
    np.testing.assert_allclose(other(nd.array(x)).asnumpy(), ref,
                               atol=ATOL)
    f3 = str(tmp_path / "legacy.params")
    with pytest.warns(DeprecationWarning):
        pnet.save_params(f3)
    with mx.name.NameManager():
        third = _mlp(mx)
    with pytest.warns(DeprecationWarning):
        third.load_params(f3)
    np.testing.assert_allclose(third(nd.array(x)).asnumpy(), ref,
                               atol=ATOL)


# ------------------------------------------------------ export, both ways
def _conv_net(pkg):
    g = pkg.gluon
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Conv2D(4, 3, padding=1, in_channels=3),
                g.nn.BatchNorm(in_channels=4), g.nn.Activation("relu"),
                g.nn.MaxPool2D(2), g.nn.Flatten(),
                g.nn.Dense(5, in_units=64))
    return net


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The same small conv net with BatchNorm exported by each package
    (weights carried by value, running statistics made non-trivial), its
    logits, and the input."""
    d = tmp_path_factory.mktemp("export")
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 8, 8).astype("float32")
    with jmx.name.NameManager():
        jnet = _conv_net(jmx)
    with mx.cpu(), mx.name.NameManager():
        pnet = _conv_net(mx)
    jnet.initialize()
    with mx.cpu():
        pnet.initialize()
    for k, p in jnet.collect_params().items():
        val = rng.uniform(0.5, 1.5, p.shape) if k.endswith("var") \
            else rng.randn(*p.shape) * 0.3
        p.set_data(jmx.nd.array(val.astype("float32")))
    _carry(jnet, pnet)
    jnet.hybridize()
    pnet.hybridize()
    ref = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        live = pnet(nd.array(x)).asnumpy()
    np.testing.assert_allclose(live, ref, atol=ATOL)
    return {"jax": jnet.export(str(d / "jax")),
            "port": pnet.export(str(d / "port")), "x": x, "ref": ref}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_loads_in_both_packages(exported, writer):
    """Either package's export, loaded by either package's
    ``SymbolBlock.imports``, gives the live net's logits (atol 1e-5)."""
    sym, params = exported[writer]
    x = exported["x"]
    port = gluon.SymbolBlock.imports(sym, ["data"], params, ctx=mx.cpu())
    jax_ = jmx.gluon.SymbolBlock.imports(sym, ["data"], params)
    np.testing.assert_allclose(port(nd.array(x)).asnumpy(),
                               exported["ref"], atol=ATOL)
    np.testing.assert_allclose(jax_(jmx.nd.array(x)).asnumpy(),
                               exported["ref"], atol=ATOL)
    assert sorted(port.collect_params()) == sorted(jax_.collect_params())
    aux = sorted(k for k, p in port.collect_params().items()
                 if p.grad_req == "null")
    assert aux and all(k.endswith(("running_mean", "running_var"))
                       for k in aux)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_imported_block_fine_tunes_like_jax(exported, writer):
    """One SGD step (training-mode BatchNorm, momentum 0.9, wd 1e-3) on
    the port's block imported from either package's export, against the
    same step of the JAX net the export came from (its values read back
    from the ``.params`` file; the JAX package's own ``SymbolBlock``
    records no gradient): the loss and every parameter and moving
    statistic after the step agree (atol 1e-5)."""
    sym, params = exported[writer]
    x = exported["x"]
    y = np.array([1, 3], "float32")
    port = gluon.SymbolBlock.imports(sym, ["data"], params, ctx=mx.cpu())
    with jmx.name.NameManager():
        jnet = _conv_net(jmx)
    jnet.collect_params().load(params)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
    ptr = gluon.Trainer(port.collect_params(), "sgd", dict(opt))
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    with autograd.record():
        pl = gluon.loss.SoftmaxCrossEntropyLoss()(port(nd.array(x)),
                                                  nd.array(y))
    pl.backward()
    ptr.step(2)
    with jmx.autograd.record():
        jl = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(jmx.nd.array(x)), jmx.nd.array(y))
    jl.backward()
    jtr.step(2)
    np.testing.assert_allclose(pl.asnumpy(), jl.asnumpy(), atol=ATOL)
    jparams = jnet.collect_params()
    assert sorted(port.collect_params()) == sorted(jparams)
    for k, p in port.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jparams[k].data().asnumpy(), atol=ATOL,
                                   err_msg=k)


# ---------------------------------------------------------- the no-wd rule
def _no_wd_run(pkg, path, x, y):
    with pkg.name.NameManager():
        net = jvision.get_model("resnet18_v1", classes=10) if pkg is jmx \
            else get_model("resnet18_v1", classes=10, device="cpu")
    net.load_parameters(path)
    net.collect_params(NO_WD).setattr("wd_mult", 0.0)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4})
    if pkg is mx:       # the rule reached the optimizer, by name
        wds = {p.name: trainer._optimizer._get_wd(i)
               for i, p in enumerate(trainer._params)}
        assert {k for k, v in wds.items() if v == 0.0} == \
            set(net.collect_params(NO_WD))
        assert all(v == 1e-4 for k, v in wds.items()
                   if not k.endswith(("beta", "gamma", "bias")))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
        loss.backward()
        trainer.step(len(x))
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def resnet18_file(tmp_path_factory):
    """Seeded ResNet-18 v1 values in a ``.params`` file that the port
    writes and both packages load."""
    path = str(tmp_path_factory.mktemp("r18") / "r18.params")
    rng = np.random.RandomState(5)
    net = get_model("resnet18_v1", classes=10, device="cpu")
    net(torch.zeros(1, 3, 32, 32))
    with torch.no_grad():
        for k, t in sorted(net._collect_params_with_prefix().items()):
            shape = tuple(t.shape)
            val = rng.uniform(0.5, 1.5, shape) \
                if k.endswith("running_var") else rng.randn(*shape) * (
                    0.1 if k.endswith(("beta", "bias", "running_mean"))
                    else np.sqrt(2.0 / max(1, np.prod(shape[1:]))))
            t.copy_(torch.from_numpy(val.astype("float32")))
    net.save_parameters(path)
    return path


def test_no_wd_rule_matches_jax(resnet18_file):
    """GluonCV's ``--no-wd``: ``collect_params('.*beta|.*gamma|.*bias')
    .setattr('wd_mult', 0.0)``, then 2 SGD steps (lr 0.01, momentum 0.9,
    wd 1e-4) of ResNet-18 v1 at (2, 3, 64, 64): every parameter and
    running statistic equals the JAX package's within 1e-4 of its tensor's
    max (two backends, 18 layers; measured 5.6e-6, the JAX package's own
    distance under a reordering of the batch), and the port's optimizer
    gives wd 0 exactly to the rule's parameters.  At 32 x 32 the last
    stage's BatchNorms see 2 values a channel (batch 2 of 1 x 1 maps), and
    the JAX package moves by 14x its tensors' max under a reordering: no
    comparison holds there."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 64, 64).astype("float32")
    y = np.array([2, 7], "float32")
    port = _no_wd_run(mx, resnet18_file, x, y)
    ref = _no_wd_run(jmx, resnet18_file, x, y)
    assert list(port) == list(ref)
    for k in ref:
        scale = max(np.abs(ref[k]).max(), 1e-30)
        assert np.abs(port[k] - ref[k]).max() <= 1e-4 * scale, k


# -------------------------------------------------- new layers, the ops
LAYER_CASES = [
    ("InstanceNorm", lambda m: m.InstanceNorm(in_channels=3, scale=True),
     (2, 3, 5, 4)),
    ("InstanceNorm_axis", lambda m: m.InstanceNorm(axis=2), (2, 5, 3)),
    ("GlobalMaxPool2D", lambda m: m.GlobalMaxPool2D(), (2, 3, 5, 4)),
    ("GlobalMaxPool2D_NHWC", lambda m: m.GlobalMaxPool2D(layout="NHWC"),
     (2, 5, 4, 3)),
    ("GlobalMaxPool1D", lambda m: m.GlobalMaxPool1D(), (2, 3, 7)),
    ("GlobalMaxPool1D_NWC", lambda m: m.GlobalMaxPool1D(layout="NWC"),
     (2, 7, 3)),
    ("ReflectionPad2D", lambda m: m.ReflectionPad2D(2), (1, 2, 5, 6)),
    ("LeakyReLU", lambda m: m.LeakyReLU(0.2), (3, 4)),
    ("HybridLambda", lambda m: m.HybridLambda("tanh"), (3, 4)),
    ("Sequential", lambda m: _seq(m), (3, 4)),
]


def _seq(m):
    net = m.Sequential()
    with net.name_scope():
        net.add(m.Dense(5, in_units=4), m.Lambda("relu"))
    return net


@pytest.mark.parametrize("name,make,shape", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_new_layers_match_jax(name, make, shape):
    """Each layer of the slice: output and input gradient against the JAX
    layer on the same input and parameters (atol 1e-5)."""
    x = np.random.RandomState(7).randn(*shape).astype("float32")
    with jmx.name.NameManager():
        jl = make(jmx.gluon.nn)
    with mx.name.NameManager():
        pl = make(nn)
    jl.initialize()
    pl.initialize()
    jx, px = jmx.nd.array(x), nd.array(x)
    jl(jx)
    pl(px)
    if list(jl.collect_params()):
        rng = np.random.RandomState(8)
        for p in jl.collect_params().values():
            p.set_data(jmx.nd.array(rng.randn(*p.shape).astype("float32")))
        _carry(jl, pl)
    jx.attach_grad()
    px.attach_grad()
    with jmx.autograd.record():
        jy = jl(jx)
    jy.backward()
    with autograd.record():
        py = pl(px)
    py.backward()
    np.testing.assert_allclose(py.asnumpy(), jy.asnumpy(), atol=ATOL)
    np.testing.assert_allclose(px.grad.asnumpy(), jx.grad.asnumpy(),
                               atol=ATOL)


def test_instance_norm_op_matches_jax():
    from mxnet_tpu.ops import nn as jops
    from mxnet_tpu_torch.ops import nn as ops
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 4, 5).astype("float32")
    g, b = rng.randn(3).astype("float32"), rng.randn(3).astype("float32")
    want = np.asarray(jops.instance_norm(x, g, b, eps=1e-3))
    got = ops.instance_norm(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(b), 1e-3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# ------------------------------------------------------------ initializers
def _init(pkg, init, shape, name="w_weight"):
    p = pkg.gluon.Parameter(name, shape=shape, init=init)
    p.initialize()
    return p.data().asnumpy()


@pytest.mark.parametrize("case", ["bilinear", "lstmbias", "load", "mixed"])
def test_deterministic_initializers_match_jax(case):
    """``Bilinear``, ``LSTMBias``, ``Load`` and ``Mixed`` fill the same
    values in both packages (exactly)."""
    src = np.arange(12, dtype="float32").reshape(3, 4)

    def make(pkg):
        i = pkg.init
        return {"bilinear": (i.Bilinear(), (2, 1, 4, 4)),
                "lstmbias": (i.LSTMBias(forget_bias=2.0), (8,)),
                "load": (i.Load({"arg:w_weight": pkg.nd.array(src)},
                                default_init=i.Zero()), (3, 4)),
                "mixed": (i.Mixed([".*bias", ".*"],
                                  [i.One(), i.Constant(3.0)]), (3, 4))}[case]
    jinit, shape = make(jmx)
    pinit, _ = make(mx)
    np.testing.assert_array_equal(_init(mx, pinit, shape),
                                  _init(jmx, jinit, shape))
    if case in ("load", "mixed"):
        np.testing.assert_array_equal(
            _init(mx, pinit, (2,), "other_bias"),
            _init(jmx, jinit, (2,), "other_bias"))


def test_orthogonal_initializer_is_orthogonal():
    """``Orthogonal`` draws its own values: held by its property, rows
    (or columns) orthonormal times ``scale``."""
    w = _init(mx, mx.init.Orthogonal(scale=1.5), (4, 6))
    np.testing.assert_allclose(w @ w.T, 1.5 ** 2 * np.eye(4), atol=1e-5)
    w = _init(mx, mx.init.Orthogonal(rand_type="normal"), (6, 2, 2))
    flat = w.reshape(6, 4)
    np.testing.assert_allclose(flat.T @ flat, 1.414 ** 2 * np.eye(4),
                               atol=1e-4)
