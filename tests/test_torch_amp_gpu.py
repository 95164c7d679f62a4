"""AMP and multi-precision on the card: the policy on CUDA tensors, the
flash kernel in bf16 under AMP, training BatchNorm under AMP on the
bn-stats kernel, and fp16 ``cast`` with multi-precision SGD against the
CPU.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_amp_gpu.py

TF32 is switched off so that fp32 means fp32.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.ops import bn_stats as bs
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import registry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    amp.deinit()


_CASES = [("FullyConnected", torch.float32, torch.bfloat16),
          ("Convolution", torch.float32, torch.bfloat16),
          ("batch_dot", torch.float32, torch.bfloat16),
          ("softmax", torch.bfloat16, torch.float32),
          ("LayerNorm", torch.bfloat16, torch.float32),
          ("BatchNorm", torch.bfloat16, torch.float32),
          ("relu", torch.bfloat16, torch.bfloat16),
          ("relu", torch.float32, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,src,dst", _CASES)
def test_policy_on_cuda_tensors(cuda, name, src, dst):
    """The policy casts CUDA tensors as CPU ones and keeps them on the
    card; BatchNorm's moving statistics are never cast."""
    amp.init()
    xs = [torch.ones(3, 4, device=cuda, dtype=src) for _ in range(5)]
    out = registry.amp_policy((name,), xs)
    for i, t in enumerate(out):
        want = src if name == "BatchNorm" and i >= 3 else dst
        assert t.is_cuda and t.dtype == want, (name, i, t.dtype)


@pytest.mark.gpu
def test_bert_flash_kernel_runs_in_bf16_under_amp(cuda):
    """A 2-layer bert_tiny training step under AMP launches the flash
    kernel on bf16 q, k, v (one launch and one backward call a layer) and
    never the plain version on the card; its attention output equals the
    plain version's on the same bf16 inputs within the output's
    rounding."""
    net = tbert.get_bert_model("bert_tiny", vocab_size=100, max_length=128,
                               dropout=0.0, device=cuda)
    net.initialize(generator=torch.Generator(device=cuda).manual_seed(0))
    seen, real = [], fa._reference

    def guard(q, k, v, causal, scale):
        seen.append(q.device.type)
        return real(q, k, v, causal, scale)
    dtypes = []
    hook = net.encoder.layers[0].attention.register_forward_hook(
        lambda m, a, o: dtypes.append(o.dtype))
    fa._reference = guard
    amp.init()
    tok = torch.randint(0, 100, (4, 128), device=cuda)
    fa.flash_attention.launches = fa.flash_attention.backward_calls = 0
    try:
        with ag.record():
            seq, pooled = net(tok, torch.zeros_like(tok))[:2]
            loss = seq.float().sum() + pooled.float().sum()
        ag.backward(loss)
        torch.cuda.synchronize()
    finally:
        fa._reference = real
        hook.remove()
    assert fa.flash_attention.launches == 2
    assert fa.flash_attention.backward_calls == 2
    assert "cuda" not in seen and dtypes == [torch.bfloat16]
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(32, 12, 128, 64, device=cuda, generator=g)
               .bfloat16() for _ in range(3))
    out = fa.flash_attention(q, k, v)
    ref = fa._reference(q.float(), k.float(), v.float(), False, 0.125)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_training_batchnorm_under_amp_runs_the_kernel_in_fp32(cuda):
    """``nn.BatchNorm`` in training under AMP, fed bf16: its input is cast
    to fp32 and the bn-stats kernel runs once on it; the output and the
    moving statistics match the CPU plain path within 1e-4."""
    x = torch.randn(32, 64, 28, 28).bfloat16()
    outs = []
    for dev in ("cpu", cuda):
        layer = gluon.nn.BatchNorm(in_channels=64, device=dev)
        layer.initialize()
        amp.init()
        bs.bn_stats.launches = 0
        try:
            with ag.record():
                y = layer(x.to(dev))
        finally:
            amp.deinit()
        outs.append((y.float().cpu(), layer.running_mean.tensor().cpu(),
                     bs.bn_stats.launches, y.dtype))
    (yc, mc, nc, dc), (yg, mg, ng, dg) = outs
    assert dc == dg == torch.float32 and nc == 0 and ng == 1
    assert (yg - yc).abs().max().item() <= 1e-4 * yc.abs().max().item()
    assert (mg - mc).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_fp16_cast_and_multi_precision_sgd_against_cpu(cuda):
    """ResNet-18 v1 ``cast("float16")`` (BatchNorm stays fp32) and
    ``SGD(multi_precision=True, momentum=0.9)``: two steps at batch 8 on
    the card and on the CPU from the same weights; the fp16 bn-stats
    instantiation runs 20 times a forward.  The fp32 masters agree within
    twice the CPU fp16 run's own noise, as ``chip_smoke.py`` phase 19
    holds it: the larger of its distance from itself with the batch
    reordered (two orders) and from the same training in fp32 (largest
    over tensors of max |a - b| / max |b|): fp16 rounding is
    discontinuous, so the card's summation orders draw its noise anew."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 3, 64, 64).astype("float32")
    y = rng.randint(0, 10, 8).astype("float32")
    ref = get_model("resnet18_v1", classes=10, device="cpu")
    ref.initialize()
    ref(torch.from_numpy(x[:1]))
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    perm = np.roll(np.arange(8), 3)
    results = []
    for dev, order, half in (("cpu", np.arange(8), True),
                             (cuda, np.arange(8), True),
                             ("cpu", perm, True), ("cpu", perm[::-1], True),
                             ("cpu", np.arange(8), False)):
        net = get_model("resnet18_v1", classes=10, device=dev)
        net(torch.from_numpy(x[:1]).to(dev))
        net.load_state_dict({k: v.to(dev) for k, v in state.items()})
        if half:
            net.cast("float16")
        trainer = gluon.Trainer(net.collect_params(), "sgd", dict(
            learning_rate=0.01, momentum=0.9, multi_precision=True))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        bs.bn_stats.launches = 0
        for _ in range(2):
            xs = torch.from_numpy(x[order]).to(dev)
            with ag.record():
                loss = loss_fn(net(xs.half() if half else xs),
                               torch.from_numpy(y[order]).to(dev))
            ag.backward(loss)
            trainer.step(8)
        if dev != "cpu":
            torch.cuda.synchronize()
        # the fp32 value of each weight that fp16 training keeps a master of
        values = {i: (s[0] if isinstance(s, tuple) else
                      trainer._params[i].tensor()).float().cpu()
                  for i, s in trainer._updater.states.items()
                  if trainer._params[i].tensor().dim() > 1}
        results.append((values, bs.bn_stats.launches))
    (mc, nc), (mg, ng), (mr, _), (ms, _), (m32, _) = results
    assert nc == 0 and ng == 2 * 20
    assert sorted(mc) == sorted(mg) == sorted(m32) and mc
    assert all(mg[i].dtype == torch.float32 for i in mg)

    def rel(a):
        return max((a[i] - mc[i]).abs().max().item() /
                   mc[i].abs().max().item() for i in mc)
    noise = max(rel(mr), rel(ms), rel(m32))
    assert rel(mg) <= 2 * noise, (rel(mg), noise)
