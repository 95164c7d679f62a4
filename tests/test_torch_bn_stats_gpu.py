"""The port's CUDA bn-stats kernel against its plain version, on the card.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package, so on a machine with the card it
runs without them:

    python -m pytest --noconftest -q tests/test_torch_bn_stats_gpu.py

Shapes are the nine BatchNorm inputs of ResNet-50 at 224 and batch 32
(``benchmark/pallas_bn_stats.py:113-119``), plus a ragged and a large-mean
case.  TF32 is switched off so that fp32 means fp32.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import bn_stats as bs
from mxnet_tpu_torch.ops import nn as ops

RESNET50_BN = [(32, 64, 112, 112), (32, 64, 56, 56), (32, 256, 56, 56),
               (32, 128, 28, 28), (32, 512, 28, 28), (32, 256, 14, 14),
               (32, 1024, 14, 14), (32, 512, 7, 7), (32, 2048, 7, 7)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _x(shape, dev, dtype=torch.float32, mean=0.0, std=0.5, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * std + mean
    return x.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RESNET50_BN + [(3, 5, 7, 9), (2, 3, 1, 1),
                                                  (4, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shifted", [False, True])
def test_kernel_matches_plain_on_card(cuda, shape, dtype, shifted):
    """Mean and biased variance against the plain version on the same
    input (fp32 accumulation both; atol 2e-5 on a variance of 0.25)."""
    x = _x(shape, cuda, getattr(torch, dtype))
    pivot = x.reshape(shape[0], shape[1], -1)[0, :, 0].float().contiguous() \
        if shifted else None
    before = bs.bn_stats.launches
    mean, var = bs.bn_stats(x, pivot)
    torch.cuda.synchronize()
    assert bs.bn_stats.launches == before + 1
    assert mean.dtype == var.dtype == torch.float32
    assert mean.shape == var.shape == (shape[1],)
    rmean, rvar = bs._reference(x, pivot)
    torch.testing.assert_close(mean, rmean, rtol=0, atol=2e-5)
    torch.testing.assert_close(var, rvar, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_mean_is_exact_with_the_pivot(cuda, dtype):
    """Mean 1000, std 1: shifted by the pivot, the variance stays within
    1e-4 of a float64 computation and the mean within 1e-6 relative."""
    x = _x((8, 16, 28, 28), cuda, getattr(torch, dtype), mean=1000.0,
           std=1.0)
    mean, var = bs.bn_stats(x, x[0, :, 0, 0].float().contiguous())
    x64 = x.double()
    torch.testing.assert_close(var.double(),
                               x64.var((0, 2, 3), unbiased=False),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(mean.double(), x64.mean((0, 2, 3)),
                               rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_two_runs_give_the_same_bits(cuda):
    x = _x((32, 64, 56, 56), cuda)
    a = bs.bn_stats(x, x[0, :, 0, 0].contiguous())
    b = bs.bn_stats(x, x[0, :, 0, 0].contiguous())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_layouts_the_kernel_refuses(cuda):
    """A strided view, another dtype and a bad pivot raise; a
    ``channels_last`` tensor is taken (the channels-last entry)."""
    x = _x((4, 8, 6, 6), cuda)
    before = bs.bn_stats.launches_cl
    bs.bn_stats(x.to(memory_format=torch.channels_last))
    assert bs.bn_stats.launches_cl == before + 1
    with pytest.raises(ValueError, match="non-contiguous"):
        bs.bn_stats(x[:, :, :, :3])
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        bs.bn_stats(x.double())
    with pytest.raises(ValueError, match="pivot"):
        bs.bn_stats(x, torch.zeros(8, dtype=torch.float64, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 64, 28, 28), (4, 32, 7, 7)])
def test_training_batch_norm_and_grads_match_cpu(cuda, shape):
    """Training-mode ``batch_norm`` on the card (kernel statistics) against
    the same op on the CPU (plain statistics): output, statistics and the
    input/gamma/beta gradients within 1e-4 (O(1) values)."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype("float32") * 2 + 0.5
    gamma = rng.uniform(0.5, 1.5, shape[1]).astype("float32")
    beta = rng.randn(shape[1]).astype("float32")
    dy = rng.randn(*shape).astype("float32")

    def run(dev):
        xt, gt, bt = (torch.from_numpy(a).to(dev).requires_grad_()
                      for a in (x, gamma, beta))
        out, m, v = ops.batch_norm(xt, gt, bt, None, None, 1e-5, False, 1,
                                   training=True)
        out.backward(torch.from_numpy(dy).to(dev))
        return [t.detach().cpu() for t in (out, m, v, xt.grad, gt.grad,
                                           bt.grad)]

    before = bs.bn_stats.launches
    got = run(cuda)
    assert bs.bn_stats.launches == before + 1
    for a, b in zip(got, run("cpu")):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("layout,dtype", [("channels_last", "float32"),
                                          ("channels_last", "float16"),
                                          ("strided", "float32"),
                                          ("contiguous", "float16")])
def test_training_batch_norm_any_layout_and_fp16_on_card(cuda, layout,
                                                         dtype):
    """Training-mode ``batch_norm`` takes ``channels_last``, a strided view
    and fp16 on the card through the kernel (one launch: ``channels_last``
    on the channels-last entry, a strided view on a contiguous copy) and
    gives the CPU plain path's
    output and gradients in the same dtype: within 1e-4 of each tensor's
    largest magnitude, plus one fp16 ulp of it (2^-10) in fp16, where each
    elementwise step rounds and the two devices' statistics and sums may
    round to neighbours."""
    shape = (8, 64, 28, 28)
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype("float32") * 2 + 0.5
    gamma = rng.uniform(0.5, 1.5, shape[1]).astype("float32")
    beta = rng.randn(shape[1]).astype("float32")
    dy = rng.randn(*shape).astype("float32")
    dt = getattr(torch, dtype)

    def run(dev):
        leaf = torch.from_numpy(x).to(dev, dt)
        if layout == "channels_last":
            leaf = leaf.to(memory_format=torch.channels_last)
        elif layout == "strided":
            leaf = torch.cat([leaf, leaf], dim=3)
        leaf.requires_grad_()
        xt = leaf[..., :shape[3]] if layout == "strided" else leaf
        gt, bt = (torch.from_numpy(a).to(dev, dt).requires_grad_()
                  for a in (gamma, beta))
        out, m, v = ops.batch_norm(xt, gt, bt, None, None, 1e-5, False, 1,
                                   training=True)
        out.backward(torch.from_numpy(dy).to(dev, dt))
        dx = leaf.grad[..., :shape[3]] if layout == "strided" else leaf.grad
        return [t.detach().float().cpu() for t in (out, m, v, dx, gt.grad,
                                                   bt.grad)]

    before = bs.bn_stats.launches
    got = run(cuda)
    assert bs.bn_stats.launches == before + 1
    tol = 1e-4 + (2.0 ** -10 if dtype == "float16" else 0.0)
    for a, b in zip(got, run("cpu")):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=tol * max(1.0, b.abs().max()))


# ------------------------------------------------------- channels last
RESNET50_BN_NHWC = [(n, h, w, c) for n, c, h, w in RESNET50_BN]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RESNET50_BN_NHWC + [
    (3, 5, 7, 9), (2, 3, 3, 3), (4, 6, 6, 17), (1, 1, 1, 64), (7, 1, 1000),
    (2, 2, 2, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_channels_last_entry_matches_plain_on_card(cuda, shape, dtype):
    """The channels-last entry on NHWC data (odd C, C under one warp's
    width, one row, a channel count wider than a block) against the plain
    version with the NHWC pivot, atol 2e-5; one launch, counted in
    ``launches_cl``."""
    x = _x(shape, cuda, getattr(torch, dtype))
    ax = x.dim() - 1
    pivot = x[(0,) * ax].float().contiguous()
    before, before_cl = bs.bn_stats.launches, bs.bn_stats.launches_cl
    mean, var = bs.bn_stats(x, pivot, ax)
    torch.cuda.synchronize()
    assert bs.bn_stats.launches == before + 1
    assert bs.bn_stats.launches_cl == before_cl + 1
    rmean, rvar = bs._reference(x, pivot, ax)
    torch.testing.assert_close(mean, rmean, rtol=0, atol=2e-5)
    torch.testing.assert_close(var, rvar, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,offset", [("float32", 1), ("float32", 2),
                                          ("bfloat16", 3), ("float16", 4)])
def test_channels_last_entry_misaligned_base(cuda, dtype, offset):
    """A base address off the 16-byte line narrows the load: still the
    plain version's statistics."""
    shape = (4, 6, 6, 64)
    flat = _x((math.prod(shape) + 8,), cuda, getattr(torch, dtype))
    x = flat[offset:offset + math.prod(shape)].view(shape)
    pivot = x[0, 0, 0].float().contiguous()
    mean, var, plan = bs.plan(x, pivot, 3)
    assert plan["vec"] < 16 // x.element_size()
    rmean, rvar = bs._reference(x, pivot, 3)
    torch.testing.assert_close(mean, rmean, rtol=0, atol=2e-5)
    torch.testing.assert_close(var, rvar, rtol=0, atol=2e-5)


@pytest.mark.gpu
def test_channels_last_and_nchw_entries_agree(cuda):
    """The same data through both entries (NCHW contiguous, and its NHWC
    transpose), the same pivot element: within 1e-6 in fp32; two runs of
    the channels-last entry give the same bits."""
    x = _x((32, 64, 56, 56), cuda)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    a = bs.bn_stats(x, x[0, :, 0, 0].contiguous())
    b = bs.bn_stats(nhwc, nhwc[0, 0, 0].contiguous(), 3)
    c = bs.bn_stats(nhwc, nhwc[0, 0, 0].contiguous(), 3)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=1e-6)
    assert torch.equal(b[0], c[0]) and torch.equal(b[1], c[1])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nhwc", "channels_last"])
def test_training_batch_norm_copies_nothing_channels_last(cuda, layout):
    """Training-mode ``batch_norm`` on NHWC data (``axis=3``) and on
    ``channels_last`` NCHW data (``axis=1``): one launch of the
    channels-last entry, no copy, and the CPU plain path's output and
    gradients within 1e-4 of each tensor's largest magnitude."""
    shape = (8, 28, 28, 64)
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype("float32") * 2 + 0.5
    gamma = rng.uniform(0.5, 1.5, 64).astype("float32")
    beta = rng.randn(64).astype("float32")
    dy = rng.randn(*shape).astype("float32")
    axis = 3 if layout == "nhwc" else 1

    def run(dev):
        leaf = torch.from_numpy(x).to(dev).requires_grad_()
        xt = leaf if layout == "nhwc" else leaf.permute(0, 3, 1, 2)
        gt, bt = (torch.from_numpy(a).to(dev).requires_grad_()
                  for a in (gamma, beta))
        out, m, v = ops.batch_norm(xt, gt, bt, None, None, 1e-5, False,
                                   axis, training=True)
        g = torch.from_numpy(dy).to(dev)
        out.backward(g if layout == "nhwc" else g.permute(0, 3, 1, 2))
        return [t.detach().cpu() for t in (out, m, v, leaf.grad, gt.grad,
                                           bt.grad)]

    counts = (bs.bn_stats.launches_cl, bs.bn_stats.copies)
    got = run(cuda)
    assert (bs.bn_stats.launches_cl, bs.bn_stats.copies) == \
        (counts[0] + 1, counts[1])
    for a, b in zip(got, run("cpu")):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hw,offset,vec", [
    (torch.float32, 12544, 0, 4), (torch.float32, 49, 0, 2),
    (torch.float32, 196, 0, 4), (torch.float32, 98, 0, 2),
    (torch.float32, 196, 1, 1), (torch.float32, 196, 2, 2),
    (torch.bfloat16, 784, 0, 8), (torch.bfloat16, 196, 0, 4),
    (torch.bfloat16, 49, 0, 2), (torch.bfloat16, 784, 4, 4)])
def test_vector_width_follows_hw_and_alignment(cuda, dtype, hw, offset,
                                               vec):
    """The kernel loads 16 bytes a thread where the run it walks and the
    base address allow, else the widest smaller width: a long H*W run
    (``wide``) by H*W, a short one (``rows``, 7x7 here) by C*H*W."""
    base = torch.zeros(2 * hw + 16, dtype=dtype, device=cuda)
    x = base[offset:offset + 2 * hw].view(1, 2, hw)
    assert bs.plan(x)[2]["vec"] == vec


# ------------------------------------------------ one launch, own pivot
GEOMETRIES = [(s, 1) for s in RESNET50_BN] + \
    [(s, 3) for s in RESNET50_BN_NHWC]


def _first(x, axis):
    return x[tuple(slice(None) if i == axis else 0
                   for i in range(x.dim()))].float().contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_own_pivot_is_the_explicit_pivot_bitwise(cuda, shape, axis, dtype):
    """``pivot=FIRST`` (the kernel reads x[0, c, 0, 0] itself, as the
    training path calls it) gives the bits of the explicit pivot tensor,
    and the plain version's statistics within 2e-5."""
    x = _x(shape, cuda, getattr(torch, dtype))
    mean, var = bs.bn_stats(x, bs.FIRST, axis)
    emean, evar = bs.bn_stats(x, _first(x, axis), axis)
    assert torch.equal(mean, emean) and torch.equal(var, evar)
    rmean, rvar = bs._reference(x, bs.FIRST, axis)
    torch.testing.assert_close(mean, rmean, rtol=0, atol=2e-5)
    torch.testing.assert_close(var, rvar, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_large_mean_with_the_own_pivot(cuda, axis, dtype):
    """Mean 1000, std 1, both layouts: the variance within 1e-4 of a
    float64 computation and the mean within 1e-6 relative."""
    shape = (8, 16, 28, 28) if axis == 1 else (8, 28, 28, 16)
    x = _x(shape, cuda, getattr(torch, dtype), mean=1000.0, std=1.0)
    mean, var = bs.bn_stats(x, bs.FIRST, axis)
    dims = tuple(i for i in range(4) if i != axis)
    x64 = x.double()
    torch.testing.assert_close(var.double(),
                               x64.var(dims, unbiased=False),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(mean.double(), x64.mean(dims),
                               rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", GEOMETRIES)
def test_two_runs_same_bits_every_geometry(cuda, shape, axis):
    """Whichever fold the plan takes (none, a cluster, the tickets), two
    calls give the same bits."""
    x = _x(shape, cuda)
    a = bs.bn_stats(x, bs.FIRST, axis)
    b = bs.bn_stats(x, bs.FIRST, axis)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", [((32, 64, 56, 56), 1),
                                        ((32, 256, 14, 14), 1),
                                        ((32, 28, 28, 128), 3),
                                        ((4, 6, 6, 17), 3)])
@pytest.mark.parametrize("splits", [1, 2, 8, 9, 33, 264])
@pytest.mark.parametrize("tickets", [False, True])
def test_forced_splits_fold_alike(cuda, shape, axis, splits, tickets):
    """Every fold route, forced (S = 1; 2-8 slices in a cluster, or through
    the tickets when asked; more through the tickets, in one or two
    levels): the plain version's statistics within 2e-5, the same bits
    twice, and the tickets left at zero for the next call."""
    x = _x(shape, cuda)
    m1, v1, plan = bs.plan(x, bs.FIRST, axis, splits=splits,
                           tickets=tickets)
    assert plan["splits"] == splits
    assert plan["cluster"] == (1 < splits <= 8 and not tickets)
    m2, v2, _ = bs.plan(x, bs.FIRST, axis, splits=splits, tickets=tickets)
    assert torch.equal(m1, m2) and torch.equal(v1, v2)
    rmean, rvar = bs._reference(x, bs.FIRST, axis)
    torch.testing.assert_close(m1, rmean, rtol=0, atol=2e-5)
    torch.testing.assert_close(v1, rvar, rtol=0, atol=2e-5)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream().cuda_stream
    tickets = bs._scratch[(x.device.index, stream)][1]
    assert int(tickets.count_nonzero()) == 0


@pytest.mark.gpu
def test_two_streams_concurrently_give_the_serial_bits(cuda):
    """Calls on two streams at once (each with its own tickets and
    partials) give the bits of the same calls made one after another."""
    shapes = [((32, 64, 56, 56), 1), ((32, 28, 28, 128), 3),
              ((32, 256, 14, 14), 1), ((32, 14, 14, 256), 3)]
    xs = [(_x(s, cuda, seed=i), a) for i, (s, a) in enumerate(shapes)]
    serial = [bs.bn_stats(x, bs.FIRST, a) for x, a in xs] * 4
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [None] * len(serial)
    for rep in range(4):
        for i, (x, a) in enumerate(xs):
            with torch.cuda.stream(streams[i % 2]):
                got[rep * len(xs) + i] = bs.bn_stats(x, bs.FIRST, a)
    torch.cuda.synchronize()
    for (m, v), (sm, sv) in zip(got, serial):
        assert torch.equal(m, sm) and torch.equal(v, sv)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", [((32, 64, 112, 112), 1),
                                        ((32, 512, 7, 7), 1),
                                        ((32, 56, 56, 64), 3),
                                        ((32, 7, 7, 2048), 3)])
def test_one_kernel_and_nothing_else_a_call(cuda, shape, axis):
    """torch.profiler over 5 warm calls of the training path's statistics
    (``batch_stats`` with the own pivot): 5 ``bn_stats`` kernels, and no
    other kernel, memset or copy."""
    from torch.autograd import DeviceType
    x = _x(shape, cuda)
    bs.batch_stats(x, bs.FIRST, axis)            # scratch made
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            bs.batch_stats(x, bs.FIRST, axis)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in device if "bn_stats" in e.key) == 5
    assert [e.key for e in device if "bn_stats" not in e.key] == []


@pytest.mark.gpu
def test_training_batch_norm_launches_only_the_kernel_for_stats(cuda):
    """Training ``batch_norm``'s statistics cost one launch: the forward's
    kernels are the bn_stats kernel and the normalisation's elementwise
    kernels, with no copy kernel (the pivot is read in the kernel)."""
    from torch.autograd import DeviceType
    x = _x((8, 64, 28, 28), cuda)
    g = torch.ones(64, device=cuda)
    b = torch.zeros(64, device=cuda)
    ops.batch_norm(x, g, b, None, None, 1e-5, False, 1, training=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ops.batch_norm(x, g, b, None, None, 1e-5, False, 1, training=True)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in device if "bn_stats" in e.key) == 1
    assert not [e.key for e in device
                if "copy" in e.key.lower() or "memset" in e.key.lower()]
