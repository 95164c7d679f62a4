"""The port's ResNet path against the JAX package, on the CPU.

Ops (convolution, pooling, inference BatchNorm) take the same numpy inputs
in both packages (fp32, atol 1e-5).  Whole ResNets carry their weights
across only through MXNet ``.params`` files: the JAX net's
``save_parameters`` into the port's ``load_parameters`` and back.  Logits
must agree within 1e-4 * max|logit| (fp32 both sides; the two backends sum
in different orders through up to 50 layers).
"""
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.serving import ModelRuntime as JaxRuntime

from mxnet_tpu_torch import nd
from mxnet_tpu_torch.convert import load_from_gluon
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import is_deferred
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.serving import Batcher, ModelRuntime

ATOL = 1e-5


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3)),
    dict(kernel=(3, 3), stride=(2, 1), pad=(1, 2)),
    dict(kernel=(3, 2), dilate=(2, 1), pad=(2, 0)),
    dict(kernel=(1, 1), stride=(2, 2), num_group=2),
    dict(kernel=(3, 3), pad=(1, 1), num_group=4, no_bias=True),
])
def test_convolution_matches_jax(case):
    rng = np.random.RandomState(0)
    groups = case.get("num_group", 1)
    x = rng.randn(2, 8, 11, 9).astype("float32")
    w = rng.randn(12, 8 // groups, *case["kernel"]).astype("float32")
    b = rng.randn(12).astype("float32")
    bias = () if case.get("no_bias") else (jnp.asarray(b),)
    ref = jops.convolution(jnp.asarray(x), jnp.asarray(w), *bias,
                           num_filter=12, **case)
    out = ops.convolution(torch.from_numpy(x), torch.from_numpy(w),
                          None if case.get("no_bias") else
                          torch.from_numpy(b), case.get("stride"),
                          case.get("pad"), case.get("dilate"), groups)
    _close(out, ref, 1e-4)     # sums of 72 products of unit normals


@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(2, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 3), pad=(1, 0), pool_type="avg",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full", count_include_pad=False),
    dict(kernel=(3, 2), stride=(1, 2), pool_type="sum",
         pooling_convention="full"),
    dict(kernel=(5, 5), stride=(1, 1), pad=(3, 3), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
         pooling_convention="full"),
    dict(global_pool=True, pool_type="max"),
    dict(global_pool=True, pool_type="avg"),
    dict(global_pool=True, pool_type="sum"),
])
def test_pooling_matches_jax(case):
    x = np.random.RandomState(1).randn(2, 3, 10, 11).astype("float32")
    ref = jops.pooling(jnp.asarray(x), **case)
    out = ops.pooling(torch.from_numpy(x), **case)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)


@pytest.mark.parametrize("make", [
    lambda m: m.MaxPool2D(3, 2, 1),
    lambda m: m.MaxPool2D(2, ceil_mode=True),
    lambda m: m.AvgPool2D(3, 2, 1, ceil_mode=True, count_include_pad=False),
    lambda m: m.AvgPool2D((2, 3), (1, 2)),
    lambda m: m.GlobalAvgPool2D(),
])
def test_pooling_layers_match_jax(make):
    from mxnet_tpu.gluon import nn as jnn
    x = np.random.RandomState(9).randn(2, 3, 9, 10).astype("float32")
    ref = make(jnn)(jmx.nd.array(x)).asnumpy()
    out = make(nn)(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("axis", [1, 3])
def test_batch_norm_inference_matches_jax(fix_gamma, axis):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 5, 4).astype("float32") * 3 + 1
    c = x.shape[axis]
    gamma, beta, mean = (rng.randn(c).astype("float32") for _ in range(3))
    var = rng.uniform(0.2, 2.0, c).astype("float32")
    ref = jops.batch_norm(*(jnp.asarray(a) for a in (x, gamma, beta, mean,
                                                    var)),
                          fix_gamma=fix_gamma, axis=axis)[0]
    out = ops.batch_norm(*(torch.from_numpy(a) for a in (x, gamma, beta,
                                                         mean, var)),
                         fix_gamma=fix_gamma, axis=axis)
    _close(out, ref)


def test_activation_and_flatten_match_jax():
    from mxnet_tpu.ops import elemwise, matrix
    x = np.random.RandomState(3).randn(2, 3, 4).astype("float32")
    for act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
        _close(ops.activation(torch.from_numpy(x), act),
               elemwise.activation(jnp.asarray(x), act_type=act))
    _close(ops.flatten(torch.from_numpy(x)), matrix.flatten(jnp.asarray(x)))
    with pytest.raises(ValueError):
        ops.activation(torch.from_numpy(x), "swish")


# ---------------------------------------------------------------- models
def _seeded(name, shape, rng):
    """Non-trivial values by parameter name: BN statistics with variance
    > 0, He-scaled weights, gammas under one (logits stay O(1))."""
    if name.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if name.endswith(("running_mean", "beta", "bias")):
        return rng.normal(0, 0.1, shape)
    if name.endswith("gamma"):
        return rng.uniform(0.2, 0.6, shape)
    fan_in = int(np.prod(shape[1:]))
    return rng.normal(0, np.sqrt(2.0 / fan_in), shape)


def _jax_net(name, x, seed=0):
    net = jvision.get_model(name, classes=10)
    net.initialize()
    net(jmx.nd.array(x))                       # resolve deferred shapes
    rng = np.random.RandomState(seed)
    for pname, p in sorted(net._collect_params_with_prefix().items()):
        p.set_data(jmx.nd.array(_seeded(pname, p.shape, rng)
                                .astype("float32")))
    return net


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1",
                                  "resnet18_v2"])
def test_resnet_logits_match_jax_through_params_file(name, tmp_path):
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype("float32")
    jnet = _jax_net(name, x)
    ref = jnet(jmx.nd.array(x)).asnumpy()
    port = get_model(name, classes=10, device="cpu").eval()
    assert any(is_deferred(t) for t in
               port._collect_params_with_prefix().values())
    load_from_gluon(jnet, port, tmp_path / "w.params")
    with torch.inference_mode():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 10) and np.isfinite(out).all()
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert np.abs(out - ref).max() <= 1e-4 * scale

    # and back: the port's file loads into a fresh JAX net
    port.save_parameters(str(tmp_path / "back.params"))
    jnet2 = jvision.get_model(name, classes=10)
    jnet2.load_parameters(str(tmp_path / "back.params"))
    np.testing.assert_array_equal(jnet2(jmx.nd.array(x)).asnumpy(), ref)


def test_deferred_shapes_materialise_on_first_forward_and_from_file(
        tmp_path):
    net = get_model("resnet50_v1", classes=10, device="cpu").eval()
    stem = net.features[0]
    assert is_deferred(stem.weight._data)
    net.initialize(generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        net(torch.zeros(1, 3, 32, 32))
    assert not any(is_deferred(t) for t in
                   net._collect_params_with_prefix().values())
    assert tuple(stem.weight.shape) == (64, 3, 7, 7)
    w = stem.weight.tensor()
    assert not w.is_inference() and w.requires_grad
    # initialize() reached the deferred parameters when they materialised
    w = w.detach()
    assert 0 < w.abs().max() <= 0.07
    bn = net.features[4][0].body[1]            # a deferred BatchNorm
    assert torch.equal(bn.running_var.tensor(), torch.ones(64))
    assert torch.equal(bn.running_mean.tensor(), torch.zeros(64))
    assert torch.equal(bn.gamma.tensor().detach(), torch.ones(64))
    net.save_parameters(str(tmp_path / "r50.params"))

    fresh = get_model("resnet50_v1", classes=10, device="cpu").eval()
    fresh.load_parameters(str(tmp_path / "r50.params"))
    assert tuple(fresh.features[4][0].body[0].weight.shape) == (64, 64, 1, 1)
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 3, 32, 32)
                         .astype("float32"))
    with torch.inference_mode():
        torch.testing.assert_close(fresh(x), net(x), rtol=0, atol=0)


def test_deferred_layers_and_load_errors(tmp_path):
    dense = nn.Dense(5, device="cpu")
    bn = nn.BatchNorm(device="cpu").eval()
    assert is_deferred(dense.weight._data) and \
        is_deferred(bn.running_mean._data)
    assert dense(torch.ones(2, 3, 4)).shape == (2, 5)
    assert tuple(dense.weight.shape) == (5, 12)
    bn.initialize()
    out = bn(torch.ones(2, 6, 3))
    assert tuple(bn.gamma.shape) == (6,)
    np.testing.assert_allclose(out.detach().numpy(), 1 / np.sqrt(1 + 1e-5),
                               rtol=1e-6)
    # nn.Module's train() does not switch BatchNorm to batch statistics:
    # only autograd's training flag does (as MXNet's op reads it)
    torch.testing.assert_close(bn.train()(torch.ones(2, 6, 3)), out)
    with pytest.raises(RuntimeError, match="deferred"):
        nn.Dense(5, device="cpu").save_parameters(str(tmp_path / "d.params"))
    net = get_model("resnet18_v1", classes=10, device="cpu").eval()
    net.initialize()
    net(torch.zeros(1, 3, 32, 32))
    net.save_parameters(str(tmp_path / "r18.params"))
    with pytest.raises(KeyError, match="missing from it"):
        get_model("resnet34_v1", classes=10, device="cpu").load_parameters(
            str(tmp_path / "r18.params"))
    with pytest.raises(ValueError, match="shape"):
        get_model("resnet18_v1", classes=7, device="cpu").load_parameters(
            str(tmp_path / "r18.params"))
    with pytest.raises(ValueError, match="layout"):
        get_model("resnet50_v1", layout="HWCN", device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        get_model("resnet200_v1", device="cpu")


# -------------------------------------------------------- .params format
_ALL_DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
               "int64"]


def _arrays(rng):
    out = {f"a_{dt}": (rng.randn(3, 4) * 50).astype(dt)
           for dt in _ALL_DTYPES}
    out["scalar"] = np.array(2.5, dtype="float32")
    out["empty_dims"] = np.zeros((2, 0), "float32")
    return out


def _magics(path):
    """The array magics of a .params file written without sparse data."""
    buf = open(path, "rb").read()
    pos, magics = 24, []
    (count,) = struct.unpack_from("<Q", buf, 16)
    for _ in range(count):
        magic, _, ndim = struct.unpack_from("<IiI", buf, pos)
        shape = struct.unpack_from(f"<{ndim}q", buf, pos + 12)
        flag = struct.unpack_from("<i", buf, pos + 12 + 8 * ndim + 8)[0]
        size = np.dtype(["float32", "float64", "float16", "uint8", "int32",
                         "int8", "int64"][flag]).itemsize
        pos += 12 + 8 * ndim + 12 + size * int(np.prod(shape))
        magics.append(magic)
    return magics


def test_params_port_writes_jax_reads(tmp_path):
    arrays = _arrays(np.random.RandomState(6))
    path = tmp_path / "p.params"
    nd.save(str(path), {k: torch.from_numpy(v) for k, v in arrays.items()})
    assert set(_magics(path)) == {0xF993FACA}      # one magic: V3 (0-d)
    got = jmx.nd.load(str(path))
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        g = got[k].asnumpy()
        assert g.shape == v.shape
        np.testing.assert_array_equal(g, v.astype(g.dtype))
        if v.dtype not in (np.float64, np.int64):  # JAX runs without x64
            assert g.dtype == v.dtype
    # without a 0-d array the file is all V2, as stock MXNet writes it
    nd.save(str(path), [torch.ones(2), torch.zeros(3, dtype=torch.int8)])
    assert set(_magics(path)) == {0xF993FAC9}
    assert [a.asnumpy().tolist() for a in jmx.nd.load(str(path))] == \
        [[1.0, 1.0], [0, 0, 0]]


def test_params_jax_writes_port_reads(tmp_path):
    arrays = _arrays(np.random.RandomState(7))
    path = tmp_path / "j.params"
    jmx.nd.save(str(path), {k: jmx.nd.array(v, dtype=v.dtype)
                            for k, v in arrays.items()})
    jax_dtypes = {k: a.dtype for k, a in jmx.nd.load(str(path)).items()}
    got = nd.load(str(path))
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].asnumpy().dtype == jax_dtypes[k]
        np.testing.assert_array_equal(got[k].asnumpy(),
                                      v.astype(got[k].asnumpy().dtype))
    assert got["scalar"].ndim == 0
    # every type flag, including float64/int64, round-trips in the port
    nd.save(str(path), {k: torch.from_numpy(v) for k, v in arrays.items()})
    back = nd.load_frombuffer(open(path, "rb").read())
    for k, v in arrays.items():
        assert back[k].asnumpy().dtype == v.dtype
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    with pytest.raises(ValueError, match="not an MXNet"):
        nd.load_frombuffer(b"\0" * 32)
    # bfloat16 has no type flag: written as its exact float32 values, as
    # the JAX package's writer does; bool has none either and is refused
    bf16 = torch.tensor([1.5, -2.0 ** -9, 3e38], dtype=torch.bfloat16)
    nd.save(str(path), [bf16])
    back = nd.load(str(path))[0].asnumpy()
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, bf16.float().numpy())
    assert jmx.nd.load(str(path))[0].dtype == np.float32
    with pytest.raises(TypeError, match="type flag"):
        nd.save(str(path), [torch.ones(2, dtype=torch.bool)])


def test_params_reader_takes_legacy_and_sparse_records():
    """Hand-built records the reference's loader reads: a V1 header (uint32
    dims), a row-sparse V2 payload, and the V2 0-d "empty" sentinel."""
    body = struct.pack("<I", 0xF993FAC8) + struct.pack("<I2I", 2, 2, 2) + \
        struct.pack("<iii", 1, 0, 0) + np.arange(4, dtype="float32") \
        .tobytes()
    body += struct.pack("<Ii", 0xF993FAC9, 1) + \
        struct.pack("<Iqq", 2, 1, 2) + \
        struct.pack("<Iqq", 2, 3, 2) + struct.pack("<iii", 1, 0, 0) + \
        struct.pack("<i", 6) + struct.pack("<Iq", 1, 1) + \
        np.array([[5, 6]], "float32").tobytes() + \
        np.array([2], "int64").tobytes()
    body += struct.pack("<IiI", 0xF993FAC9, 0, 0)
    buf = struct.pack("<QQQ", 0x112, 0, 3) + body + struct.pack("<Q", 0)
    a, b, c = nd.load_frombuffer(buf)
    assert a.asnumpy().tolist() == [[0, 1], [2, 3]]
    assert b.asnumpy().tolist() == [[0, 0], [0, 0], [5, 6]]
    assert c.ndim == 0


# -------------------------------------------------------------- serving
def test_resnet_served_by_port_runtime_matches_jax_runtime(tmp_path):
    rng = np.random.RandomState(8)
    reqs = [rng.randn(3, 32, 32).astype("float32") for _ in range(5)]
    jnet = _jax_net("resnet18_v1", np.stack(reqs[:1]))
    jrt = JaxRuntime(jnet, (3, 32, 32), max_batch=8, warm=False)
    ref = jrt.run_batch([jrt._normalize(r) for r in reqs])

    port = get_model("resnet18_v1", classes=10, device="cpu")
    load_from_gluon(jnet, port, tmp_path / "w.params")
    rt = ModelRuntime(port, (3, 32, 32), max_batch=8, device="cpu")
    batcher = Batcher(rt, max_latency_ms=50)
    futs = [None] * len(reqs)

    def client(i):
        futs[i] = batcher.submit(reqs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        outs = [f.result(timeout=60) for f in futs]
    finally:
        batcher.close()
    scale = max(np.abs(r).max() for r in ref)
    for out, r in zip(outs, ref):
        assert out.shape == (10,)
        assert np.abs(out - r).max() <= 1e-4 * scale
