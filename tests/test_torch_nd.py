"""``mx.nd``'s NDArray, its frontend and autograd, in the port against the
JAX package, on the CPU.

Most cases are scenarios written once against MXNet's API and run by both
packages (``nd``, ``autograd``, ``ctx`` passed in), mirroring
``tests/test_ndarray.py``, ``tests/test_ndarray_indexing.py`` and
``tests/test_autograd.py``; their numpy results must agree (fp32 rtol 1e-5,
atol 1e-6; dtypes equal).  The rest check what is the port's own: the
coverage of the op table, writes in place, outputs that never alias their
inputs, bfloat16's dtype, contexts, files, and blocks called with
NDArrays.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jax_registry

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.ops import registry

# the JAX modules whose every registered name the port's table must hold
PORTED_MODULES = ("elemwise", "broadcast_reduce", "matrix", "init_ops",
                  "random_ops")
# module 9 of the slice: what the port already computed, now in the table
REGISTERED_FROM_PORT = (
    "FullyConnected", "Convolution", "Pooling", "BatchNorm", "LayerNorm",
    "softmax", "log_softmax", "softmin", "Dropout", "Activation", "Flatten",
    "sgd_update", "sgd_mom_update", "adam_update",
    "_contrib_flash_attention", "flash_attention")
# names allowed to be missing, each queued in ROADMAP.md: none
NOT_YET_PORTED = ()


def test_op_table_covers_the_ported_modules():
    mods = {f"mxnet_tpu.ops.{m}" for m in PORTED_MODULES}
    names = [n for n in jax_registry.all_names()
             if jax_registry.get(n).fn.__module__ in mods]
    assert len(names) == 279
    missing = [n for n in names + list(REGISTERED_FROM_PORT)
               if registry.get(n) is None and n not in NOT_YET_PORTED]
    assert not missing, missing
    for n in names + list(REGISTERED_FROM_PORT):
        assert callable(getattr(mx.nd, n)), n
    # every alias the JAX package groups under one op is one op here too
    for n in names:
        for alias in jax_registry.get(n).aliases:
            if jax_registry.get(alias) is jax_registry.get(n):
                assert registry.get(alias) is registry.get(n), (n, alias)


def test_facades_strip_prefixes():
    for short in ("uniform", "normal", "gamma", "exponential", "poisson",
                  "negative_binomial", "generalized_negative_binomial",
                  "randint", "bernoulli", "multinomial", "shuffle"):
        assert callable(getattr(mx.nd.random, short)), short
        assert callable(getattr(mx.random, short)), short
    assert mx.nd.random.seed is mx.random.seed
    assert callable(mx.nd.contrib.flash_attention)
    assert callable(mx.nd.contrib.bitwise_and)


# ------------------------------------------------ scenarios run by both
def s_creation(nd, ag, ctx):
    return [nd.array([[1, 2], [3, 4]], ctx=ctx),
            nd.array(np.arange(4.0), ctx=ctx),           # float64 -> fp32
            nd.array(np.arange(4, dtype="int32"), ctx=ctx),
            nd.array([1, 2], ctx=ctx, dtype="int32"),
            nd.zeros((2, 3), ctx=ctx), nd.ones(4, ctx=ctx, dtype="int32"),
            nd.full((2, 2), 7.5, ctx=ctx), nd.empty((1, 2), ctx=ctx),
            nd.arange(2, 11, 3, ctx=ctx), nd.arange(3, ctx=ctx, repeat=2),
            nd.eye(3, 4, 1, ctx=ctx),
            nd.zeros_like(nd.ones((2, 2), ctx=ctx)),
            nd.ones_like(nd.zeros((3,), ctx=ctx))]


def _xy(nd, ctx):
    x = nd.array(np.arange(1, 13, dtype="float32").reshape(3, 4) / 4,
                 ctx=ctx)
    y = nd.array(np.linspace(-1, 2, 12, dtype="float32").reshape(3, 4),
                 ctx=ctx)
    return x, y


def s_arithmetic(nd, ag, ctx):
    x, y = _xy(nd, ctx)
    return [x + y, x - 2, 2 - x, x * y, x / 3, 3 / x, x ** 2, 2 ** x, -x,
            abs(y), x % 1.5, 7 % x, x + y[0:1], nd.maximum(x, y),
            nd.minimum(x, 0.5), nd.add(x, 1), nd.power(x, y),
            nd.modulo(x, y + 3)]


def s_inplace(nd, ag, ctx):
    a = nd.ones((2, 2), ctx=ctx)
    out = []
    for f in (lambda v: v.__iadd__(1), lambda v: v.__imul__(3),
              lambda v: v.__isub__(1), lambda v: v.__itruediv__(5)):
        a = f(a)
        out.append(a.copy())
    b = nd.array([1, 2], ctx=ctx, dtype="int32")
    b += 2.7                     # the scalar takes the array's dtype: +2
    return out + [b]


def s_comparison(nd, ag, ctx):
    a = nd.array([1.0, 2.0, 3.0], ctx=ctx)
    b = nd.array([2.0, 2.0, 2.0], ctx=ctx)
    return [a > b, a >= b, a == b, a != 2, 1 < a, 2 >= a, a < b, a <= 2,
            nd.logical_and(a > 1, b), nd.logical_or(a, 0),
            nd.equal(a, b), nd.not_equal(a, b), nd.greater(a, 1),
            nd.lesser_equal(a, b)]


def s_indexing(nd, ag, ctx):
    a = nd.array(np.arange(24).reshape(2, 3, 4), ctx=ctx)
    out = [a[1], a[0, 1, 2], a[:, 1], a[1, 0:2], a[-1], a[1][2:4],
           a[..., 1], a[:, None], a[nd.array([1.0, 0.0], ctx=ctx)],
           a[[0, 1, 1]], a[0, [2, 0]], a[:, 1:3, ::2],
           a[np.array([True, False])]]
    a[0] = 0
    a[1, 2, 3] = 99
    a[1, :, 0] = nd.array([7, 8, 9], ctx=ctx)
    a[nd.array([0.0], ctx=ctx), 1] = 1.5
    return out + [a]


def s_values_not_views(nd, ag, ctx):
    x = nd.array(np.arange(12, dtype="float32").reshape(3, 4), ctx=ctx)
    views = [x[1:3], x.reshape((4, 3)), x.T, x.expand_dims(0),
             x.slice_axis(1, 0, 2), nd.transpose(x), x[1],
             nd.BlockGrad(x), x.astype("float32"), x.flatten()]
    x[:] = -1.0
    x += 5
    return views + [x]


def s_methods(nd, ag, ctx):
    a = nd.array(np.arange(24, dtype="float32").reshape(2, 3, 4) / 7,
                 ctx=ctx)
    return [a.reshape((4, -1)), a.reshape(6, 4), a.reshape((-4, 1, 2, 0, 0)),
            a.transpose((2, 0, 1)), a.swapaxes(0, 2), a.flatten(),
            a.expand_dims(1), a.squeeze(), a.sum(), a.sum(axis=0),
            a.mean(axis=1, keepdims=True), a.max(), a.min(axis=2),
            a.prod(axis=1), a.nansum(), a.argmax(axis=1), a.argmin(),
            a.norm(), a.abs(), a.sign(), a.sqrt(), a.square(), a.exp(),
            (a + 1).log(), a.clip(0.5, 1.5), a.round(), a.softmax(),
            a.log_softmax(axis=1), a.relu(), a.sigmoid(), a.tanh(),
            a.tile((1, 2, 1)), a.repeat(2, axis=0), a.T,
            a.broadcast_to((2, 2, 3, 4)), a.sort(), a.argsort(axis=1),
            a.topk(k=2), a.slice((0, 1), (2, 3)), a.slice_axis(2, 1, 3),
            a.take(nd.array([1.0, 0.0], ctx=ctx)),
            a.reshape_like(nd.zeros((4, 6), ctx=ctx)),
            nd.array([0, 3], ctx=ctx).one_hot(5),
            a.broadcast_like(nd.zeros((2, 2, 3, 4), ctx=ctx)),
            a.dot(nd.ones((4, 2), ctx=ctx)),
            a.astype("int32"), a.astype("float16"), a.copy(),
            nd.concatenate([a, a], axis=1), nd.stack(a, a, axis=1),
            nd.moveaxis(a, 0, 2), nd.split(a, num_outputs=3, axis=1)[1],
            nd.concat(a, a, dim=2)]


def s_scalars(nd, ag, ctx):
    a = nd.array([[2.5]], ctx=ctx)
    return [np.array([a.asscalar(), a.item(), float(a), int(a), len(a),
                      a.size, a.ndim, bool(a), sum(1 for _ in
                                                   nd.ones((3, 2)))])]


def s_copyto(nd, ag, ctx):
    a = nd.array([1.5, 2.5], ctx=ctx)
    d = nd.zeros((2,), ctx=ctx)
    a.copyto(d)
    i = nd.zeros((2,), ctx=ctx, dtype="int32")
    a.copyto(i)
    c = a.copyto(ctx)
    c[0] = 100
    e = nd.zeros((2,), ctx=ctx)
    nd.elemwise_add(a, a, out=e)
    return [d, i, a, c, e, a.as_in_context(ctx)]


def s_getitem_grad(nd, ag, ctx):
    x = nd.array(np.arange(6, dtype="float32"), ctx=ctx)
    x.attach_grad()
    with ag.record():
        y = x[1:4]
        z = (y * y).sum()
    z.backward()
    return [x.grad]


def s_setitem_grad(nd, ag, ctx):
    x = nd.array(np.arange(6, dtype="float32"), ctx=ctx)
    x.attach_grad()
    with ag.record():
        y = x * 2.0
        y[0:2] = 0.0
        s = y.sum()
    s.backward()
    return [x.grad, y]


def s_inplace_grad_idiom(nd, ag, ctx):
    """``w -= lr * w.grad`` between record blocks keeps ``w`` a variable
    (``tests/test_ndarray.py:274``)."""
    w = nd.array([1.0, -2.0, 3.0], ctx=ctx)
    w.attach_grad()
    out = []
    for _ in range(3):
        with ag.record():
            loss = (w * w).sum()
        loss.backward()
        w -= 0.1 * w.grad
        out += [w.copy(), w.grad.copy()]
    return out


def s_grad_req_add_and_heads(nd, ag, ctx):
    x = nd.array([1.0, 2.0, 3.0], ctx=ctx)
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with ag.record():
            y = x * x
        y.backward(nd.array([1.0, 0.5, 2.0], ctx=ctx))
    v = nd.array([0.5, -1.0], ctx=ctx)
    v.attach_grad()
    with ag.record():
        a, b = v * 3, v * v
    ag.backward([a, b])
    u = nd.array([2.0, 3.0], ctx=ctx)
    u.attach_grad()
    with ag.record():
        z = nd.exp(u) * u
    gu = ag.grad(z, [u])[0]
    return [x.grad, v.grad, gu, z]


def s_training_mode(nd, ag, ctx):
    x = nd.array(np.arange(8, dtype="float32").reshape(2, 4), ctx=ctx)
    out = [nd.Dropout(x, p=0.5)]                 # predict mode: identity
    with ag.record():
        out.append(nd.array([ag.is_training(), ag.is_recording()],
                            ctx=ctx))
        with ag.predict_mode():
            out.append(nd.Dropout(x, p=0.5))
        with ag.pause():
            out.append(nd.array([ag.is_training(), ag.is_recording()],
                                ctx=ctx))
    return out


SCENARIOS = [s_creation, s_arithmetic, s_inplace, s_comparison, s_indexing,
             s_values_not_views, s_methods, s_scalars, s_copyto,
             s_getitem_grad, s_setitem_grad, s_inplace_grad_idiom,
             s_grad_req_add_and_heads, s_training_mode]


def _numpy(out):
    return [o if isinstance(o, np.ndarray) else o.asnumpy() for o in out]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_scenario_matches_jax(scenario):
    with mx.cpu():
        got = _numpy(scenario(mx.nd, mx.autograd, mx.cpu()))
    want = _numpy(scenario(jmx.nd, jmx.autograd, jmx.cpu()))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        # int64 stays int64 in the port; the JAX package runs without x64
        assert g.dtype == w.dtype or (g.dtype, w.dtype) == (
            np.int64, np.int32), (i, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"result {i}")


# ------------------------------------------------------- the port's own
def test_writes_outside_record_keep_the_tensor():
    """A Parameter's tensor wrapped in an NDArray sees every write made
    through the handle; inside record() the handle is rebound."""
    p = torch.nn.Parameter(torch.ones(3))
    w = mx.nd.NDArray(p)
    w += 1
    w[0] = 5.0
    mx.nd.elemwise_mul(w, w, out=w)
    mx.nd.array([1.0, 1.0, 1.0], ctx=mx.cpu()).copyto(w)
    assert w.data is p and p.tolist() == [1.0, 1.0, 1.0]
    w.attach_grad()
    leaf = w.data
    with mx.autograd.record():
        w *= 2                       # torch refuses this in place on a leaf
        loss = w.sum()
    assert w.data is not leaf
    loss.backward()
    assert leaf.grad.tolist() == [2.0, 2.0, 2.0]


def test_op_outputs_never_share_memory_with_inputs():
    x = mx.nd.array(np.arange(12.0).reshape(3, 4), ctx=mx.cpu())
    base = x.data.untyped_storage().data_ptr()
    for y in (x[1], x[:, 1:3], x.reshape((4, 3)), x.T, x.expand_dims(0),
              mx.nd.BlockGrad(x), x.astype("float32"), mx.nd.identity(x),
              mx.nd.broadcast_to(x[0:1], shape=(3, 4)), x.squeeze(),
              mx.nd.Flatten(x), mx.nd.SequenceLast(x)):
        assert y.data.untyped_storage().data_ptr() != base


def test_bfloat16_dtype_without_ml_dtypes():
    """numpy has no bfloat16: the dtype is ``mx.base.bfloat16``
    (``torch.bfloat16``), and asnumpy gives the values as float32."""
    x = mx.nd.array([1.0, 2.5, 1 / 3], ctx=mx.cpu(), dtype="bfloat16")
    assert x.dtype is mx.base.bfloat16 is torch.bfloat16
    assert mx.base.np_dtype("bfloat16") is mx.base.bfloat16
    assert mx.base.dtype_code("bfloat16") == 12
    a = x.asnumpy()
    assert a.dtype == np.float32
    assert a.tolist() == [1.0, 2.5, 0.333984375]
    assert x.astype("float32").dtype == np.float32
    assert (x + 1).dtype is mx.base.bfloat16


def test_contexts_and_scopes(monkeypatch):
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        assert mx.nd.zeros((2,)).context == mx.cpu(0)
        assert mx.nd.random.uniform(shape=(2,)).context == mx.cpu()
        assert mx.nd._arange(start=3).context == mx.cpu()
        with mx.gpu(1):
            assert mx.current_context() == mx.gpu(1)
        assert mx.current_context() == mx.cpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.current_context()
    assert mx.num_gpus() == torch.cuda.device_count()
    assert mx.Context.from_device(torch.device("cpu")) == mx.cpu()
    x = mx.nd.array([1.0], ctx=mx.cpu())
    assert x.context == x.ctx == mx.cpu()
    assert x.as_in_context(mx.cpu()) is x
    assert x.wait_to_read() is x
    mx.nd.waitall()


def test_save_load_ndarrays(tmp_path):
    a = mx.nd.array(np.arange(6.0).reshape(2, 3), ctx=mx.cpu())
    b = mx.nd.array([1, 2], ctx=mx.cpu(), dtype="int64")
    path = str(tmp_path / "x.params")
    mx.nd.save(path, {"a": a, "b": b})
    got = mx.nd.load(path)
    assert isinstance(got["a"], mx.nd.NDArray)
    assert got["a"].context == mx.cpu() and got["b"].dtype == np.int64
    np.testing.assert_array_equal(got["a"].asnumpy(), a.asnumpy())
    mx.nd.save(path, [a, b])
    back = mx.nd.load_frombuffer(open(path, "rb").read())
    assert [x.shape for x in back] == [(2, 3), (2,)]
    # the JAX package reads what the port writes
    jgot = jmx.nd.load(path)
    np.testing.assert_array_equal(jgot[0].asnumpy(), a.asnumpy())


def test_sparse_storage_raises():
    x = mx.nd.zeros((2, 2), ctx=mx.cpu())
    assert x.tostype("default") is x and x.stype == "default"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        x.tostype("row_sparse")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        x.attach_grad(stype="csr")


def test_frontend_conventions():
    x = mx.nd.array([0.0, 2.0], ctx=mx.cpu())
    # positional attributes, keyword inputs, numpy inputs
    assert mx.nd.one_hot(x, 3).shape == (2, 3)
    g = mx.nd.ones((4,), ctx=mx.cpu())
    d = mx.nd.array(np.arange(8.0).reshape(2, 4), ctx=mx.cpu())
    ln = mx.nd.LayerNorm(d, gamma=g, beta=mx.nd.zeros((4,), ctx=mx.cpu()))
    assert ln.shape == (2, 4)
    fc = mx.nd.FullyConnected(data=d, weight=mx.nd.ones((3, 4), ctx=mx.cpu()),
                              bias=mx.nd.ones((3,), ctx=mx.cpu()),
                              num_hidden=3)
    np.testing.assert_allclose(fc.asnumpy(), [[7, 7, 7], [23, 23, 23]])
    assert (mx.nd.elemwise_add(x, np.ones(2, "float32"))).context == mx.cpu()
    # out= and a list of outputs
    o = mx.nd.zeros((2,), ctx=mx.cpu())
    assert mx.nd.relu(x - 1, out=o) is o and o.asnumpy().tolist() == [0, 1]
    parts = mx.nd.split(d, num_outputs=2, axis=1)
    assert [p.shape for p in parts] == [(2, 2), (2, 2)]


def test_blocks_take_and_return_ndarrays():
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu(), generator=torch.Generator().manual_seed(0))
    x = mx.nd.array(np.ones((2, 4)), ctx=mx.cpu())
    y = net(x)
    assert isinstance(y, mx.nd.NDArray) and y.shape == (2, 3)
    assert isinstance(net(x.data), torch.Tensor)
    torch.testing.assert_close(net(x.data), y.data)
    loss = gluon.loss.L2Loss()
    with mx.autograd.record():
        out = loss(net(x), mx.nd.zeros((2, 3), ctx=mx.cpu()))
    assert isinstance(out, mx.nd.NDArray)
    out.backward()
    assert net.weight.grad is not None
    with pytest.raises(ValueError, match="one device"):
        net.initialize(ctx=[mx.cpu(), mx.cpu()])

