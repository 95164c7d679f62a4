"""The port's ``autograd`` against the JAX package's, on the CPU.

The cases of ``tests/test_autograd.py``, each run in both packages on the
same numpy inputs: gradients agree within 1e-5 (fp32, O(1) values) unless a
test says otherwise.  Dropout's random mask cannot be carried across, so
its modes are compared by their effect.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import nn as ops

ATOL = 1e-5


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


def _var(a, grad_req="write"):
    """A port leaf with a zero gradient buffer (MXNet's attach_grad)."""
    t = torch.tensor(np.asarray(a, dtype="float32"))
    ag.mark_variables(t, torch.zeros_like(t), grad_req)
    return t


def _jvar(a, grad_req="write"):
    x = jnd.array(np.asarray(a, dtype="float32"))
    x.attach_grad(grad_req=grad_req)
    return x


def test_simple_grad():
    a = [1.0, 2.0, 3.0]
    jx, x = _jvar(a), _var(a)
    with jag.record():
        jy = (jx * jx).sum()
    jy.backward()
    with ag.record():
        y = (x * x).sum()
    ag.backward(y)
    _close(x.grad, jx.grad.asnumpy())


def test_chain_fully_connected():
    rng = np.random.RandomState(0)
    a, b = rng.rand(3, 4), rng.rand(5, 4)
    jx, jw, x, w = _jvar(a), _jvar(b), _var(a), _var(b)
    with jag.record():
        jy = jnd.FullyConnected(jx, jw, no_bias=True, num_hidden=5)
        jloss = (jy * jy).sum()
    jloss.backward()
    with ag.record():
        y = ops.fully_connected(x, w)
        loss = (y * y).sum()
    ag.backward(loss)
    _close(w.grad, jw.grad.asnumpy(), 1e-4)
    _close(x.grad, jx.grad.asnumpy(), 1e-4)


def test_head_gradient_and_vector_head():
    """A head gradient scales the result; without one a vector head takes
    ones, as MXNet does (torch's own ``.backward()`` refuses it)."""
    jx, x = _jvar([1.0, 2.0]), _var([1.0, 2.0])
    with jag.record():
        jy = jx * 3
    jy.backward(jnd.array([10.0, 20.0]))
    with ag.record():
        y = x * 3
    ag.backward(y, torch.tensor([10.0, 20.0]))
    _close(x.grad, jx.grad.asnumpy())
    with jag.record():
        jy = jx * jx
    jy.backward()
    with ag.record():
        y = x * x
    ag.backward(y)
    _close(x.grad, jx.grad.asnumpy())


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_overwrites_and_add_accumulates(req):
    jx, x = _jvar([1.0, 2.0], req), _var([1.0, 2.0], req)
    for _ in range(2):
        with jag.record():
            jy = (jx * jx).sum()
        jy.backward()
        with ag.record():
            y = (x * x).sum()
        ag.backward(y)
    _close(x.grad, jx.grad.asnumpy())
    np.testing.assert_allclose(x.grad.numpy(),
                               [4.0, 8.0] if req == "add" else [2.0, 4.0])


def test_pause_and_training_flags():
    x = _var([1.0])
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        assert torch.is_grad_enabled()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
            z = x * 2                       # not recorded
            assert not z.requires_grad
        y = x * 3 + z
    ag.backward(y)
    np.testing.assert_allclose(x.grad.numpy(), [3.0])
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
        with ag.predict_mode():
            assert not ag.is_training()
    assert ag.set_training(True) is False
    assert ag.set_training(False) is True
    assert not ag.is_training()


def test_flags_are_per_thread():
    import threading
    seen = []
    with ag.record():
        t = threading.Thread(
            target=lambda: seen.append((ag.is_recording(),
                                        ag.is_training())))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [(False, False)]


def test_mark_variables_writes_the_given_buffer():
    jx, jg = jnd.array([2.0]), jnd.zeros((1,))
    jag.mark_variables([jx], [jg])
    with jag.record():
        jy = jx * jx * jx
    jy.backward()
    x, g = torch.tensor([2.0]), torch.zeros(1)
    ag.mark_variables([x], [g])
    with ag.record():
        y = x * x * x
    ag.backward(y)
    assert x.grad is g
    _close(g, jg.asnumpy())
    with pytest.raises(ValueError, match="grad_req"):
        ag.mark_variables([x], [g], "sometimes")


def test_multiple_heads():
    jx, x = _jvar([1.0, 2.0]), _var([1.0, 2.0])
    with jag.record():
        jy1, jy2 = jx * 2, jx * 3
    jag.backward([jy1, jy2])
    with ag.record():
        y1, y2 = x * 2, x * 3
    ag.backward([y1, y2])
    _close(x.grad, jx.grad.asnumpy())


def test_grad_function_leaves_buffers_alone():
    jx, x = _jvar([3.0]), _var([3.0])
    with jag.record():
        jy = jx * jx
    jdx = jag.grad(jy, jx)
    with ag.record():
        y = x * x
    dx = ag.grad(y, x)
    _close(dx, jdx.asnumpy())
    np.testing.assert_allclose(x.grad.numpy(), [0.0])


def test_higher_order_grad():
    a = [1.0, 2.0, 3.0]
    jx, x = _jvar(a), _var(a)
    with jag.record():
        jy = jnd.sin(jx).sum()
        jg1 = jag.grad(jy, jx, create_graph=True)
        jz = jg1.sum()
    jz.backward()
    with ag.record():
        y = torch.sin(x).sum()
        g1 = ag.grad(y, x, create_graph=True)
        z = g1.sum()
    ag.backward(z)
    _close(x.grad, jx.grad.asnumpy())


class _JSquare(jag.Function):
    def forward(self, x):
        self.save_for_backward(x)
        return x * x

    def backward(self, dy):
        x, = self.saved_tensors
        return 2 * x * dy


class _Square(ag.Function):
    def forward(self, x):
        assert not ag.is_recording()
        self.save_for_backward(x)
        return x * x

    def backward(self, dy):
        x, = self.saved_tensors
        return 2 * x * dy


def _nd_var(a):
    x = pnd.array(np.asarray(a, dtype="float32"), ctx=mx.cpu())
    x.attach_grad()
    return x


def test_custom_function():
    """A ``Function`` called on NDArrays inside ``record()`` takes and
    returns NDArrays and records its node, as the reference's does
    (``mxnet_tpu/autograd.py:385``)."""
    jx, x = _jvar([1.0, 4.0]), _nd_var([1.0, 4.0])
    with jag.record():
        jy = _JSquare()(jx).sum()
    jy.backward()
    with ag.record():
        y = _Square()(x)
        assert isinstance(y, pnd.NDArray)
        y = y.sum()
    y.backward()
    _close(x.grad.data, jx.grad.asnumpy())


def test_custom_function_square_at_three():
    """``x * x`` at 3.0 through a ``Function`` on an NDArray: gradient
    6.0 in both packages."""
    jx, x = _jvar([3.0]), _nd_var([3.0])
    with jag.record():
        jy = _JSquare()(jx)
    jy.backward()
    with ag.record():
        y = _Square()(x)
    y.backward()
    np.testing.assert_array_equal(jx.grad.asnumpy(), [6.0])
    np.testing.assert_array_equal(x.grad.asnumpy(), [6.0])


def test_custom_function_on_tensors():
    """Raw tensors keep working: tensors in, tensors out."""
    jx, x = _jvar([1.0, 4.0]), _var([1.0, 4.0])
    with jag.record():
        jy = _JSquare()(jx).sum()
    jy.backward()
    with ag.record():
        y = _Square()(x)
        assert isinstance(y, torch.Tensor)
        y = y.sum()
    ag.backward(y)
    _close(x.grad, jx.grad.asnumpy())


def test_detach_blocks_grad():
    jx, x = _jvar([2.0]), _var([2.0])
    with jag.record():
        jz = (jx * 2).detach() * jx
    jz.backward()
    with ag.record():
        z = (x * 2).detach() * x
    ag.backward(z)
    _close(x.grad, jx.grad.asnumpy())


def test_unrecorded_head_raises():
    x = _var([1.0])
    y = x.detach() * 2
    with pytest.raises(ValueError, match="record"):
        ag.backward(y)


def test_blocks_record_only_inside_record():
    """Outside ``record()`` a block's forward builds no graph, even with
    torch's grad mode on; inside it does."""
    dense = nn.Dense(3, in_units=4, device="cpu")
    dense.initialize()
    x = torch.ones(2, 4)
    assert torch.is_grad_enabled()
    assert not dense(x).requires_grad
    with ag.record():
        assert dense(x).requires_grad


def test_dropout_modes():
    x = torch.ones(100, 100)
    drop = nn.Dropout(0.5)
    jx = jnd.ones((100, 100))
    torch.testing.assert_close(drop(x), x)               # predict: identity
    np.testing.assert_array_equal(jnd.Dropout(jx, p=0.5).asnumpy(),
                                  jx.asnumpy())
    drop.eval()                       # nn.Module.training does not decide
    with ag.record(), jag.record():
        z = drop(x)
        jz = jnd.Dropout(jx, p=0.5)
    frac, jfrac = (z == 0).float().mean().item(), (jz.asnumpy() == 0).mean()
    assert 0.45 < frac < 0.55 and 0.45 < jfrac < 0.55
    # survivors are scaled by 1 / (1 - p) in both
    assert set(np.unique(z.numpy())) == set(np.unique(jz.asnumpy())) \
        == {0.0, 2.0}
    with ag.record(train_mode=False):
        torch.testing.assert_close(drop(x), x)


def test_batchnorm_moving_stats_update():
    """``BatchNorm`` inside ``record()`` normalises with the batch
    statistics and moves the running ones (momentum 0.5) exactly as
    ``nd.BatchNorm`` does; outside it uses the running statistics even in
    ``nn.Module`` train mode (atol 1e-5)."""
    x = (np.random.RandomState(0).randn(8, 4, 5, 5) * 3 + 1) \
        .astype("float32")
    gamma, beta = np.ones(4, "float32"), np.zeros(4, "float32")
    jmm, jmv = jnd.zeros((4,)), jnd.ones((4,))
    with jag.record():
        jy = jnd.BatchNorm(jnd.array(x), jnd.array(gamma), jnd.array(beta),
                           jmm, jmv, momentum=0.5, fix_gamma=False)
    bn = nn.BatchNorm(momentum=0.5, epsilon=1e-3, in_channels=4,
                      device="cpu")
    bn.initialize()
    bn.train()
    y_infer = bn(torch.from_numpy(x))
    _close(y_infer, x / np.sqrt(1 + 1e-3))
    assert torch.equal(bn.running_mean.tensor(), torch.zeros(4))
    with ag.record():
        y = bn(torch.from_numpy(x))
    _close(y, jy.asnumpy())
    _close(bn.running_mean.tensor(), jmm.asnumpy())
    _close(bn.running_var.tensor(), jmv.asnumpy())
    assert not np.allclose(bn.running_mean.tensor().numpy(), 0)
    bn.eval()                           # nn.Module mode does not enter
    with ag.record():
        bn(torch.from_numpy(x))
    assert not np.allclose(bn.running_mean.tensor().numpy(), jmm.asnumpy())
    # use_global_stats keeps the running statistics even when training
    frozen = nn.BatchNorm(use_global_stats=True, in_channels=4,
                          device="cpu")
    frozen.initialize()
    with ag.record():
        _close(frozen(torch.from_numpy(x)), x / np.sqrt(1 + 1e-5))
    assert torch.equal(frozen.running_mean.tensor(), torch.zeros(4))


@pytest.mark.parametrize("fn", ["sin_x", "cube", "tanh_sq"])
def test_backward_create_graph_then_second_backward(fn):
    """``backward(create_graph=True)`` leaves a recorded gradient in the
    buffer; a second ``backward`` of a function of it gives the second
    derivative (``sum(grad^2)`` differentiates to ``2 f' f''``), as the
    JAX package's tape does."""
    a = [0.5, -1.0, 2.0]
    jx, x = _jvar(a), _var(a)
    jf = {"sin_x": lambda v: jnd.sin(v) * v, "cube": lambda v: v * v * v,
          "tanh_sq": lambda v: jnd.tanh(v) * jnd.tanh(v)}[fn]
    tf = {"sin_x": lambda v: torch.sin(v) * v, "cube": lambda v: v * v * v,
          "tanh_sq": lambda v: torch.tanh(v) * torch.tanh(v)}[fn]
    with jag.record():
        jy = jf(jx).sum()
    jag.backward(jy, create_graph=True)
    jg1 = jx.grad.asnumpy().copy()
    with jag.record():
        jz = (jx.grad * jx.grad).sum()
    jz.backward()
    with ag.record():
        y = tf(x).sum()
    ag.backward(y, create_graph=True)
    assert x.grad.requires_grad
    _close(x.grad, jg1)
    with ag.record():
        z = (x.grad * x.grad).sum()
    ag.backward(z)
    assert not x.grad.requires_grad
    _close(x.grad, jx.grad.asnumpy(), 1e-4)


def test_backward_create_graph_with_head_grads_and_add():
    """``create_graph`` with head gradients, and ``grad_req="add"``: the
    first pass adds into the buffer as a recorded sum; a second-order
    backward of it matches the JAX package."""
    a = [0.3, 1.2]
    jx, x = _jvar(a, "add"), _var(a, "add")
    hg = [2.0, -1.0]
    with jag.record():
        jy = jx * jx * jx
    jag.backward(jy, jnd.array(np.asarray(hg, "float32")),
                 create_graph=True)
    with ag.record():
        y = x * x * x
    ag.backward(y, torch.tensor(hg), create_graph=True)
    _close(x.grad, jx.grad.asnumpy())
    with jag.record():
        jz = (jx.grad * jnd.array(np.asarray([1.0, 3.0], "float32"))).sum()
    jz.backward()
    with ag.record():
        z = (x.grad * torch.tensor([1.0, 3.0])).sum()
    ag.backward(z)
    _close(x.grad, jx.grad.asnumpy(), 1e-4)
