"""``Module`` training on the card against the CPU plain path.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_module_gpu.py

A 2-stage symbolic ResNet v1 (``chip_smoke.resnet_v1_symbol``, 9
BatchNorms) at (8, 3, 32, 32) takes 3 SGD steps through ``Module``
(kvstore ``'local'``) on ``mx.gpu(0)`` and on ``mx.cpu()`` from the same
seeded weights: outputs, step-1 gradients and final parameters within
1e-4 of each tensor's largest magnitude (TF32 off), and every training
forward on the card launches the bn-stats kernel once per BatchNorm (the
plain statistics never see a CUDA tensor).  ``Module.fit`` with an
``NDArrayIter`` runs on the card and its outputs stay there.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import bn_stats as bs
from chip_smoke import resnet_v1_symbol

SHAPE, STEPS, TOL = (8, 3, 32, 32), 3, 1e-4
BN_PER_FORWARD = 9
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mx.gpu(0)


def _sym():
    return resnet_v1_symbol(mx.sym, [1, 1], [16, 32, 64], 10)


def _init(sym):
    rng = np.random.RandomState(0)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=SHAPE)
    args = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:] or (1,))))
            .astype("float32") for n, s in zip(sym.list_arguments(),
                                                arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: (rng.rand(*s) + 0.5 if n.endswith("var")
                else rng.randn(*s) * 0.1).astype("float32")
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _train(ctx, x, y):
    sym = _sym()
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (SHAPE[0],))])
    mod.set_params(*_init(sym))
    mod.init_optimizer(kvstore="local", optimizer_params=dict(OPT))
    outs, grads = [], None
    for step in range(STEPS):
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                             [mx.nd.array(y, ctx=ctx)]))
        outs.append(mod.get_outputs()[0])
        if step == 0:
            grads = {k: v.asnumpy().copy()
                     for k, v in mod._exec.grad_dict.items()}
        mod.update()
    arg, aux = mod.get_params()
    return outs, grads, {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


@pytest.mark.gpu
def test_module_steps_on_card_match_cpu(cuda, monkeypatch):
    rng = np.random.RandomState(1)
    x = rng.randn(*SHAPE).astype("float32")
    y = rng.randint(0, 10, SHAPE[0]).astype("float32")
    ref = _train(mx.cpu(), x, y)
    plain = bs._reference

    def guarded(t, pivot=None):
        assert not t.is_cuda, "plain bn statistics on a CUDA tensor"
        return plain(t, pivot)

    monkeypatch.setattr(bs, "_reference", guarded)
    before = bs.bn_stats.launches
    got = _train(cuda, x, y)
    torch.cuda.synchronize()
    assert bs.bn_stats.launches - before == BN_PER_FORWARD * STEPS
    assert all(o.context == cuda for o in got[0])
    for a, b in zip(got[0], ref[0]):
        b = b.asnumpy()
        np.testing.assert_allclose(a.asnumpy(), b, rtol=0,
                                   atol=TOL * np.abs(b).max())
    for what in (1, 2):
        assert sorted(got[what]) == sorted(ref[what])
        for k, b in ref[what].items():
            np.testing.assert_allclose(got[what][k], b, rtol=0,
                                       atol=TOL * max(np.abs(b).max(),
                                                      1e-30), err_msg=k)


@pytest.mark.gpu
def test_fit_runs_on_the_card(cuda):
    rng = np.random.RandomState(2)
    x = rng.randn(32, 3, 32, 32).astype("float32")
    y = rng.randint(0, 10, 32).astype("float32")
    mod = mx.mod.Module(_sym(), context=cuda)
    before = bs.bn_stats.launches
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            optimizer_params=dict(OPT), eval_metric=["acc", "ce"])
    assert bs.bn_stats.launches - before == BN_PER_FORWARD * 4 * 2
    assert mod.get_outputs()[0].context == cuda
    assert all(v.context == cuda for v in mod.get_params()[0].values())
