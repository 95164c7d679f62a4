"""Gluon's parameter lifecycle, its layer signatures and NDArray's
negative-step indexing in the port, held against the JAX package on the
CPU with numpy-seeded inputs.

- ``initialize()`` keeps an initialised parameter (one that an earlier
  ``initialize`` filled or ``load_parameters`` loaded) unless
  ``force_reinit`` (``mxnet_tpu/gluon/parameter.py:127-131``).
- ``load_parameters(filename, ctx, allow_missing, ignore_extra,
  cast_dtype)`` in the reference's order, and a file of a block without
  parameters loads (``mxnet_tpu/gluon/block.py:276-312``).
- Every layer of the port takes the JAX package's arguments in its order,
  names and defaults (but for ``prefix``/``params``), with ``dtype`` as a
  name and the ``*_initializer`` arguments.
- ``x[::-1]``, ``x[:, ::-2]`` and ``x[1:0:-1]`` read and write as the
  reference's basic indexing does, and a reversed slice keeps its
  gradient under ``autograd.record()``.
- A built-in layer's parameter attributes (``weight``, ``bias``,
  ``gamma``, ``running_mean``...) are its Gluon ``Parameter``s, as in the
  reference (``mxnet_tpu/gluon/nn/basic_layers.py:117``): ``data()``,
  ``grad()``, ``set_data()``, ``list_ctx()``, ``zero_grad()``, deferred
  access, ``cast``/``dtype``, and ``lr_mult``/``wd_mult``/``grad_req`` set
  on the attribute reach the ``Trainer``.

Values are compared exactly where both packages copy the same numbers, and
within fp32 tolerances (stated per test) where they compute.
"""
import inspect
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon

# fp32 results of the same arithmetic in the two packages
ATOL = 1e-6


def _net(pkg, **kw):
    """Dense(4) -> BatchNorm -> Dense(2), widths given (no deferral)."""
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4, in_units=3, **kw),
            pkg.gluon.nn.BatchNorm(in_channels=4, **kw),
            pkg.gluon.nn.Dense(2, in_units=4, **kw))
    return net


def _jax_params(path):
    """A JAX-package file of :func:`_net` with numpy-seeded values."""
    jnet = _net(jmx)
    jnet.initialize()
    rng = np.random.RandomState(0)
    for p in jnet.collect_params().values():
        p.set_data(jmx.nd.array(rng.randn(*p.shape).astype("float32")))
    jnet.save_parameters(str(path))
    return jnet


def _port_values(net):
    return {k: v.detach().numpy().copy()
            for k, v in net._collect_params_with_prefix().items()}


def _jax_values(net):
    return {k: v.data().asnumpy() for k, v in
            net._collect_params_with_prefix().items()}


# ------------------------------------------------------------ initialize
def test_initialize_keeps_loaded_weights_like_jax(tmp_path):
    """load then initialize(): both packages keep the file's values bit for
    bit (the port with MXNet's warning); force_reinit=True fills them
    again, to the same constants in both."""
    path = tmp_path / "net.params"
    jnet = _jax_params(path)
    want = _jax_values(jnet)
    jnet.initialize()
    net = _net(mx, device="cpu")
    net.load_parameters(str(path))
    with pytest.warns(UserWarning, match="already initialized"):
        net.initialize()
    got = _port_values(net)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(_jax_values(jnet)[k], v, err_msg=k)

    jnet.initialize(jmx.init.Constant(0.5), force_reinit=True)
    net.initialize(mx.init.Constant(0.5), force_reinit=True)
    got, ref = _port_values(net), _jax_values(jnet)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert not np.array_equal(got["0.weight"], want["0.weight"])


def test_initialize_twice_keeps_the_first_fill_like_jax():
    """A second initialize() keeps what the first drew; a parameter still
    deferred takes the last initialize()'s initializer when the first
    forward gives its shape, and is kept by a later initialize() -- in
    both packages."""
    def build(pkg, **kw):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(4, in_units=3, **kw),
                pkg.gluon.nn.Dense(2, **kw))
        return net
    net, jnet = build(mx, device="cpu"), build(jmx)
    net.initialize(mx.init.Uniform(1.0))
    jnet.initialize(jmx.init.Uniform(1.0))
    first = net[0].weight.tensor().detach().clone()
    jfirst = jnet[0].weight.data().asnumpy().copy()
    with pytest.warns(UserWarning, match="force_reinit"):
        net.initialize(mx.init.Constant(3.0))
    jnet.initialize(jmx.init.Constant(3.0))
    assert torch.equal(net[0].weight.tensor(), first)
    np.testing.assert_array_equal(jnet[0].weight.data().asnumpy(), jfirst)
    net(torch.ones(5, 3))
    jnet(jmx.nd.ones((5, 3)))
    np.testing.assert_array_equal(net[1].weight.tensor().detach().numpy(),
                                  jnet[1].weight.data().asnumpy())
    deferred = net[1].weight.tensor().detach().clone()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net.initialize(mx.init.Constant(5.0))
    assert torch.equal(net[1].weight.tensor(), deferred)


# ------------------------------------------------------- load_parameters
def test_load_parameters_signature_matches_jax():
    port = list(inspect.signature(
        gluon.nn.HybridSequential.load_parameters).parameters.items())
    ref = list(inspect.signature(
        jgluon.nn.HybridSequential.load_parameters).parameters.items())
    assert [(n, p.default) for n, p in port] == \
        [(n, p.default) for n, p in ref]


def test_load_parameters_ctx_missing_extra_like_jax(tmp_path):
    """``ctx`` places the values; a file short of a parameter or holding an
    extra one raises in both packages, and loads with allow_missing /
    ignore_extra, the missing parameter keeping its value."""
    path = tmp_path / "net.params"
    _jax_params(path)
    net = _net(mx, device="cpu")
    net.load_parameters(str(path), ctx=mx.cpu())
    assert all(t.device.type == "cpu"
               for t in net._collect_params_with_prefix().values())

    # the file has an extra layer: a smaller net
    small, jsmall = gluon.nn.HybridSequential(), jgluon.nn.HybridSequential()
    small.add(gluon.nn.Dense(4, in_units=3, device="cpu"))
    jsmall.add(jgluon.nn.Dense(4, in_units=3))
    jsmall.initialize()
    with pytest.raises(Exception):
        jsmall.load_parameters(str(path))
    with pytest.raises(KeyError):
        small.load_parameters(str(path))
    jsmall.load_parameters(str(path), ignore_extra=True)
    small.load_parameters(str(path), ignore_extra=True)
    np.testing.assert_array_equal(small[0].weight.tensor().detach().numpy(),
                                  jsmall[0].weight.data().asnumpy())

    # the file lacks a layer: a larger net
    def big(pkg, **kw):
        n = _net(pkg, **kw)
        n.add(pkg.gluon.nn.Dense(5, in_units=2, **kw))
        return n
    port, jport = big(mx, device="cpu"), big(jmx)
    jport.initialize(jmx.init.Constant(0.25))
    port.initialize(mx.init.Constant(0.25))
    with pytest.raises(Exception):
        jport.load_parameters(str(path))
    with pytest.raises(KeyError):
        port.load_parameters(str(path))
    jport.load_parameters(str(path), allow_missing=True)
    port.load_parameters(str(path), allow_missing=True)
    got, ref = _port_values(port), _jax_values(jport)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert (got["3.weight"] == 0.25).all()


def _pools(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.MaxPool2D(), pkg.gluon.nn.GlobalAvgPool2D())
    return net


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port", "port")])
def test_parameterless_block_round_trips(tmp_path, writer, reader):
    """A pooling-only HybridSequential saves a file with no arrays, and
    either package loads either package's file; the block then runs."""
    path = str(tmp_path / "pools.params")
    (_pools(jmx) if writer == "jax" else _pools(mx)).save_parameters(path)
    net = _pools(jmx) if reader == "jax" else _pools(mx)
    net.load_parameters(path)
    x = np.random.RandomState(3).randn(2, 3, 4, 4).astype("float32")
    want = x.reshape(2, 3, 2, 2, 2, 2).max(axis=(3, 5)).mean(
        axis=(2, 3), keepdims=True)
    if reader == "jax":
        out = net(jmx.nd.array(x)).asnumpy()
    else:
        out = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)


# ----------------------------------------------------- layer signatures
LAYERS = ["Dense", "Dropout", "Embedding", "LayerNorm", "BatchNorm",
          "Flatten", "Activation", "GELU", "HybridSequential", "Conv1D",
          "Conv2D", "Conv3D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _args(fn, skip=()):
    return [(n, p.default) for n, p in
            inspect.signature(fn).parameters.items()
            if p.kind is p.POSITIONAL_OR_KEYWORD and n not in skip]


@pytest.mark.parametrize("name", LAYERS)
def test_layer_signature_matches_jax(name):
    """The port's positional-or-keyword arguments are the JAX layer's, in
    order, with equal defaults, ``prefix``/``params`` aside (every layer
    takes them, keyword only where the JAX layer takes them through
    ``**kwargs``); the port's own (``dtype`` where the reference has
    none, ``device``) are keyword only."""
    port, ref = getattr(gluon.nn, name), getattr(jgluon.nn, name)
    skip = ("prefix", "params")
    assert _args(port.__init__, skip) == _args(ref.__init__, skip)
    extra = [n for n, p in inspect.signature(port.__init__)
             .parameters.items() if p.kind is p.KEYWORD_ONLY]
    assert {"prefix", "params"} <= set(
        inspect.signature(port.__init__).parameters)
    assert set(extra) <= {"dtype", "device", "prefix", "params"}


def test_positional_and_dtype_string_construction_matches_jax():
    """Layers built positionally and with ``dtype="float32"`` compute what
    the JAX layers built the same way compute, with the same weights
    (atol 1e-6); ``LayerNorm()`` defers its width."""
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6).astype("float32")
    cases = [(lambda m: m.Dense(3, "relu", True, True, "float32"), x),
             (lambda m: m.LayerNorm(), x),
             (lambda m: m.LayerNorm(-1, 1e-3, True, False), x),
             (lambda m: m.BatchNorm(1, 0.9, 1e-5), x),
             (lambda m: m.Conv2D(4, 3, 1, 1), x.reshape(1, 1, 4, 6)),
             (lambda m: m.Conv1D(2, 3, 1, 0, 1, 1, "NCW", "tanh"),
              x.reshape(2, 2, 6)),
             (lambda m: m.Embedding(10, 4, "float32"),
              np.array([[1, 2], [9, 0]], "float32"))]
    for make, data in cases:
        jl, pl = make(jgluon.nn), make(gluon.nn)
        jl.initialize()
        jout = jl(jmx.nd.array(data))
        pl(torch.from_numpy(data))              # materialise deferred shapes
        for k, v in jl._collect_params_with_prefix().items():
            with torch.no_grad():
                getattr(pl, k).tensor().copy_(
                    torch.tensor(v.data().asnumpy()))
        with autograd.record():                 # BatchNorm: batch stats
            out = pl(torch.from_numpy(data))
        with jmx.autograd.record():
            jout = jl(jmx.nd.array(data))
        np.testing.assert_allclose(out.detach().numpy(), jout.asnumpy(),
                                   rtol=0, atol=ATOL)
        assert all(t.dtype == torch.float32 for t in pl.parameters())


def test_per_parameter_initializers_match_jax():
    """``weight_initializer``/``bias_initializer`` and BatchNorm's four
    ``*_initializer`` fill their own parameter in both packages; the
    block's initializer fills the rest."""
    def layers(m, init):
        return [m.Dense(3, in_units=2, weight_initializer="ones",
                        bias_initializer=init.Constant(2.0)),
                m.Conv2D(2, 1, in_channels=1, weight_initializer="zeros",
                         bias_initializer="ones"),
                m.Embedding(4, 3, weight_initializer=init.Constant(-1.0)),
                m.LayerNorm(in_channels=3, beta_initializer="ones",
                            gamma_initializer="zeros"),
                m.BatchNorm(in_channels=3, beta_initializer="ones",
                            gamma_initializer=init.Constant(3.0),
                            running_mean_initializer="ones",
                            running_variance_initializer="zeros")]
    for jl, pl in zip(layers(jgluon.nn, jmx.init),
                      layers(gluon.nn, mx.init)):
        jl.initialize(jmx.init.Constant(7.0))
        pl.initialize(mx.init.Constant(7.0), ctx=mx.cpu())
        for k, v in jl._collect_params_with_prefix().items():
            np.testing.assert_array_equal(
                getattr(pl, k).tensor().detach().numpy(), v.data().asnumpy(),
                err_msg=f"{type(pl).__name__}.{k}")


def test_dropout_axes_shares_the_mask():
    """``Dropout(rate, axes)``: in training the mask is shared along
    ``axes`` (scaled by 1 / (1 - rate)); outside it the identity."""
    drop = gluon.nn.Dropout(0.5, (1,))
    x = torch.ones(64, 8)
    assert torch.equal(drop(x), x)
    with autograd.record():
        y = drop(x)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert (y == y[:, :1]).all()


# -------------------------------------------------- negative-step index
KEYS = {"rev": np.s_[::-1], "cols_by_2": np.s_[:, ::-2],
        "one_back": np.s_[1:0:-1], "both": np.s_[2::-2, 3:0:-1],
        "empty": np.s_[0:2:-1], "row_then_rev": np.s_[1, ::-1]}


@pytest.mark.parametrize("key", list(KEYS))
def test_negative_step_getitem_and_setitem_match_jax(key):
    """Reads and writes through a negative-step slice give the JAX
    package's arrays (exact)."""
    k = KEYS[key]
    x = np.random.RandomState(1).randn(3, 5).astype("float32")
    with mx.cpu():
        a = mx.nd.array(x)
        got = a[k].asnumpy()
        v = np.arange(got.size, dtype="float32").reshape(got.shape)
        b = mx.nd.array(x)
        b[k] = mx.nd.array(v)
    ja = jmx.nd.array(x)
    want = ja[k].asnumpy()
    jb = jmx.nd.array(x)
    jb[k] = jmx.nd.array(v)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(b.asnumpy(), jb.asnumpy())


def test_reversed_slice_keeps_its_gradient_like_jax():
    """A recorded ``x[:, ::-1]`` and ``x[::-2]`` backpropagate the JAX
    package's gradient (exact: the gradient is a scatter of the weights)."""
    x = np.random.RandomState(2).randn(4, 3).astype("float32")
    w1 = np.random.RandomState(3).randn(4, 3).astype("float32")
    w2 = np.random.RandomState(4).randn(2, 3).astype("float32")

    def run(pkg, nd):
        a = nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = (a[:, ::-1] * nd.array(w1)).sum() + \
                (a[::-2] * nd.array(w2)).sum()
        y.backward()
        return a.grad.asnumpy()
    with mx.cpu():
        got = run(mx, mx.nd)
    np.testing.assert_array_equal(got, run(jmx, jmx.nd))


# ---------------------------------------- a layer's attributes: Parameters
def _layers(pkg, **kw):
    nn = pkg.gluon.nn
    return {
        "Dense": (nn.Dense(3, in_units=2, **kw), ("weight", "bias")),
        "Embedding": (nn.Embedding(5, 3, **kw), ("weight",)),
        "LayerNorm": (nn.LayerNorm(in_channels=3, **kw), ("gamma", "beta")),
        "InstanceNorm": (nn.InstanceNorm(in_channels=3, **kw),
                         ("gamma", "beta")),
        "BatchNorm": (nn.BatchNorm(in_channels=3, **kw),
                      ("gamma", "beta", "running_mean", "running_var")),
        "Conv1D": (nn.Conv1D(4, 3, in_channels=2, **kw), ("weight", "bias")),
        "Conv2D": (nn.Conv2D(4, 3, in_channels=2, use_bias=False, **kw),
                   ("weight",)),
        "Conv3D": (nn.Conv3D(4, 2, in_channels=2, **kw), ("weight", "bias")),
        "PReLU": (nn.PReLU(**kw), ("alpha",)),
    }


@pytest.mark.parametrize("name", ["BatchNorm", "Conv1D", "Conv2D", "Conv3D",
                                  "Dense", "Embedding", "InstanceNorm",
                                  "LayerNorm", "PReLU"])
def test_layer_attributes_are_parameters_like_jax(name):
    """Each attribute is the Parameter ``collect_params()`` holds under the
    reference's prefixed name, with the JAX package's shape; its value is
    the tensor torch registered, so ``state_dict`` still holds it."""
    layer, attrs = _layers(mx, device="cpu")[name]
    jlayer, _ = _layers(jmx)[name]
    params = layer.collect_params()
    jparams = jlayer.collect_params()
    for attr in attrs:
        p, jp = getattr(layer, attr), getattr(jlayer, attr)
        assert isinstance(p, gluon.Parameter), (name, attr)
        assert isinstance(jp, jgluon.Parameter), (name, attr)
        assert params[p.name] is p
        assert p.name[len(layer.prefix):] == jp.name[len(jlayer.prefix):]
        assert p.shape == jp.shape, (name, attr)
    layer.initialize()
    state = layer.state_dict()
    for attr in attrs:
        assert getattr(layer, attr).tensor() is state[attr] or \
            torch.equal(getattr(layer, attr).tensor(), state[attr])


def test_bert_decoder_bias_is_a_parameter():
    """BERT's masked-LM ``decoder_bias`` is a Parameter, as the reference's
    ``params.get`` makes it (``mxnet_tpu/models/bert.py:200``)."""
    from mxnet_tpu_torch.models import bert
    net = bert.get_bert_model("bert_tiny", vocab_size=11, max_length=8,
                              device="cpu")
    assert isinstance(net.decoder_bias, gluon.Parameter)
    assert net.decoder_bias.shape == (11,)
    assert net.decoder_bias.name in net.collect_params()


def _sgd_step(pkg, nd, attrs, use_bias):
    """One SGD step (lr 0.1, wd 0.5) of ``Dense(1, in_units=2)`` on
    all-ones data, ``attrs`` {(parameter, setting): value} set on the
    layer's attributes; returns the weight and bias after it."""
    net = pkg.gluon.nn.Dense(1, in_units=2, use_bias=use_bias)
    net.initialize()
    net.weight.set_data(nd.array([[0.5, -0.25]]))
    if use_bias:
        net.bias.set_data(nd.array([0.75]))
    for (param, key), value in attrs.items():
        setattr(getattr(net, param), key, value)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "wd": 0.5})
    with pkg.autograd.record():
        loss = net(nd.ones((4, 2))).sum()
    loss.backward()
    trainer.step(1)
    return (net.weight.data().asnumpy(),
            net.bias.data().asnumpy() if use_bias else None)


@pytest.mark.parametrize("attrs, use_bias", [
    ({("weight", "lr_mult"): 2.0}, False),
    ({("weight", "wd_mult"): 0.25}, True),
    ({("bias", "lr_mult"): 3.0, ("weight", "wd_mult"): 0.0}, True),
    ({("bias", "grad_req"): "null"}, True),
], ids=["lr_mult", "wd_mult", "both", "grad_req_null"])
def test_settings_on_the_attribute_reach_the_trainer_like_jax(attrs,
                                                               use_bias):
    """``lr_mult``, ``wd_mult`` and ``grad_req`` set on ``layer.weight`` /
    ``layer.bias`` change the step as they do in the JAX package; a bias
    with ``grad_req='null'`` keeps its value."""
    with mx.cpu():
        got = _sgd_step(mx, mx.nd, attrs, use_bias)
    want = _sgd_step(jmx, jmx.nd, attrs, use_bias)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    if use_bias:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)
    if ("bias", "grad_req") in attrs:
        np.testing.assert_array_equal(got[1], [0.75])
    # the step moved the weight away from its start
    assert not np.allclose(got[0], [[0.5, -0.25]])


def test_parameter_methods_on_the_attribute_like_jax():
    """``data``/``grad``/``set_data``/``list_ctx``/``zero_grad`` on
    ``layer.weight``: values and gradients as the JAX package gives."""
    def run(pkg, nd, ctx):
        net = pkg.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=ctx)
        w = np.arange(6, dtype="float32").reshape(2, 3) / 10
        net.weight.set_data(nd.array(w))
        assert net.weight.list_ctx() == [ctx]
        x = nd.array(np.random.RandomState(0).randn(4, 3).astype("float32"))
        with pkg.autograd.record():
            loss = (net(x) * net(x)).sum()
        loss.backward()
        grad = net.weight.grad().asnumpy().copy()
        data = net.weight.data().asnumpy().copy()
        net.weight.zero_grad()
        return data, grad, net.weight.grad().asnumpy()
    with mx.cpu():
        got = run(mx, mx.nd, mx.cpu(0))
    want = run(jmx, jmx.nd, jmx.cpu(0))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=ATOL)
    assert np.abs(got[1]).sum() > 0
    np.testing.assert_array_equal(got[2], want[2])
    assert not got[2].any()


def test_deferred_attribute_access_raises_like_jax():
    """``layer.weight.data()`` before the first forward gives the width
    raises ``DeferredInitializationError`` in both packages; after it the
    shape is known."""
    from mxnet_tpu.gluon.parameter import DeferredInitializationError as JD
    from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError
    net = gluon.nn.Dense(3, device="cpu")
    jnet = jgluon.nn.Dense(3)
    net.initialize()
    jnet.initialize()
    with pytest.raises(JD):
        jnet.weight.data()
    with pytest.raises(DeferredInitializationError):
        net.weight.data()
    net(torch.ones(2, 5))
    jnet(jmx.nd.ones((2, 5)))
    assert net.weight.shape == jnet.weight.shape == (3, 5)


def test_cast_and_dtype_on_the_attribute_like_jax():
    """``cast("float16")`` gives ``layer.weight`` the dtype the JAX package
    reports, its data and the forward's output follow
    (``tests/test_gluon_contracts2.py``'s contract)."""
    net = gluon.nn.Dense(3, in_units=2, device="cpu")
    jnet = jgluon.nn.Dense(3, in_units=2)
    net.initialize()
    jnet.initialize()
    assert net.weight.dtype == jnet.weight.dtype == "float32"
    net.cast("float16")
    jnet.cast("float16")
    assert net.weight.dtype == jnet.weight.dtype == "float16"
    assert net.weight.data().dtype == jnet.weight.data().dtype == np.float16
    with mx.cpu():
        out = net(mx.nd.ones((2, 2), dtype="float16"))
    assert out.dtype == jnet(jmx.nd.ones((2, 2), dtype="float16")).dtype
