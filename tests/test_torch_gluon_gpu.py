"""Fine-tuning an imported ``SymbolBlock`` on the card trains as the Gluon
net it was exported from.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q -s tests/test_torch_gluon_gpu.py

ResNet-50 v1 at full width (1000 classes, (3, 224, 224), fp32, TF32 off)
is built as ``chip_smoke.py``'s phase 24 builds it (``name_scope``, the
no-wd rule, phase 6's seeded weights).  It is exported either untrained or
after 13 SGD steps at batch 32 on seeded data, as phase 24 (b) trains it
before its export.  The export, loaded by ``SymbolBlock.imports`` under a
``Dense(10)`` head, takes 2 SGD steps at batch 8 on the card; the Gluon
net loaded from the same values under the same head takes the same steps.
With cuDNN's deterministic algorithms the two give the same losses and
final logits bit for bit, and each launches the bn-stats kernel 53 times a
training forward.

Each case also prints phase 8's parity reading of the imported block: its
card run with cuDNN's default algorithms against the CPU run, beside the
CPU run's largest spread over three reorderings of the batch (the smoke's
tolerance is twice that spread, or 1e-4 if larger).
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.ops import bn_stats as bs
import chip_smoke as cs

TRIALS = [None, 0, 1, 2, 3, 4, 5]      # None: phase 6's weights untrained
TRAIN_STEPS = cs.WARM_STEPS + cs.TIMED_STEPS
STEPS = cs.PARITY_STEPS


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mx.gpu(0)


@pytest.fixture(scope="module")
def weights(cuda, tmp_path_factory):
    """Phase 6's seeded ResNet-50 v1 values in a ``.params`` file."""
    net = get_model("resnet50_v1", classes=1000, device="cpu").eval()
    with torch.inference_mode():
        net(torch.zeros(1, 3, 32, 32))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, t in sorted(net._collect_params_with_prefix().items()):
            t.copy_(torch.from_numpy(cs._seeded(name, tuple(t.shape), rng)
                                     .astype("float32")))
    path = tmp_path_factory.mktemp("r50") / "resnet50_v1.params"
    net.save_parameters(str(path))
    return path


@contextlib.contextmanager
def _deterministic():
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _gluon_under_head(path, ctx, head):
    """The Gluon net from ``path`` on the card under ``head``, as the
    imported block stands under it (without the no-wd rule: an imported
    block's parameters carry none)."""
    with mx.name.NameManager():
        body = get_model("resnet50_v1", classes=1000)
    body.load_parameters(str(path), ctx=ctx)
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(body, gluon.nn.Dense(cs.FT_CLASSES, in_units=1000))
    net[1].initialize(ctx=ctx)
    with torch.no_grad():
        net[1].weight.tensor().copy_(torch.from_numpy(head[0]))
        net[1].bias.tensor().copy_(torch.from_numpy(head[1]))
    return net


def _steps_and_logits(net, x, y):
    """``STEPS`` SGD steps of phase 8's loop; returns the losses of each
    step, then the logits of ``x`` in predict mode, on the host."""
    out = cs._train(net, x, y, STEPS)[0]
    with torch.no_grad():
        out.append(net(x).cpu().numpy())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("trial", TRIALS,
                         ids=["untrained"] + [f"trained{t}"
                                              for t in TRIALS[1:]])
def test_imported_block_fine_tunes_as_the_gluon_net(cuda, weights, trial,
                                                    tmp_path, monkeypatch):
    rng = np.random.RandomState(24 if trial is None else 100 + trial)
    net = cs._gluon_resnet(weights, None)
    if trial is not None:              # phase 24 (b)'s training
        x32 = torch.from_numpy(rng.randn(cs.TRAIN_BATCH, *cs.IMAGE)
                               .astype("float32")).cuda()
        y32 = torch.from_numpy(rng.randint(0, 1000, cs.TRAIN_BATCH)
                               .astype("float32")).cuda()
        with _deterministic():
            cs._timed_steps(net, x32, y32, TRAIN_STEPS, 0)
        del x32, y32
    x8 = rng.randn(cs.PARITY_BATCH, *cs.IMAGE).astype("float32")
    net.hybridize()
    with torch.no_grad():
        net(torch.from_numpy(x8).cuda())
    files = net.export(str(tmp_path / "resnet50_v1"))
    trained = tmp_path / "trained.params"
    net.save_parameters(str(trained))
    del net
    head = (rng.randn(cs.FT_CLASSES, 1000).astype("float32") * 0.01,
            np.zeros(cs.FT_CLASSES, "float32"))
    y10 = rng.randint(0, cs.FT_CLASSES, cs.PARITY_BATCH).astype("float32")

    plain = bs._reference

    def guarded(t, *args, **kwargs):
        assert not t.is_cuda, "plain bn statistics on a CUDA tensor"
        return plain(t, *args, **kwargs)

    monkeypatch.setattr(bs, "_reference", guarded)
    xc, yc = torch.from_numpy(x8).cuda(), torch.from_numpy(y10).cuda()
    runs = []
    with _deterministic():
        for build in (cs._finetune_net, _gluon_under_head):
            src = files if build is cs._finetune_net else trained
            before = bs.bn_stats.launches
            runs.append(_steps_and_logits(build(src, cuda, head), xc, yc))
            torch.cuda.synchronize()
            launches = bs.bn_stats.launches - before
            assert launches == cs.BN_PER_FORWARD * STEPS
    for got, want in zip(*runs):
        assert np.array_equal(got, want), np.abs(got - want).max()

    # phase 8's parity reading of the imported block, for the record
    def cpu_run(order):
        run = cs._train(cs._finetune_net(files, mx.cpu(), head),
                        torch.from_numpy(x8[order]),
                        torch.from_numpy(y10[order]), STEPS)
        return [l[np.argsort(order)] for l in run[0]], run[1], run[2]

    ref = cpu_run(np.arange(cs.PARITY_BATCH))
    others = [cpu_run(p) for p in cs._reorderings(cs.PARITY_BATCH)]
    card = cs._train(cs._finetune_net(files, cuda, head), xc, yc, STEPS)
    picks = [(f"loss {i + 1}", lambda r, i=i: {"l": r[0][i]})
             for i in range(STEPS)]
    picks += [("grads 1", lambda r: r[1]), ("params", lambda r: r[2])]
    reading = []
    for what, pick in picks:
        spread = max(cs._rel(pick(o), pick(ref))[0] for o in others)
        err = cs._rel(pick(card), pick(ref))[0]
        reading.append(f"{what}: card {err:.3e} spread {spread:.3e} "
                       f"({err / max(2 * spread, 1e-4):.2f} of tol)")
    print(f"\n[finetune parity] {'untrained' if trial is None else trial}"
          f": " + "; ".join(reading))
