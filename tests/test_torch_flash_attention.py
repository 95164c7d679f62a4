"""The port's flash attention (mxnet_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernel.

The JAX side runs as tests/test_pallas_kernels.py runs it (interpret mode on
the CPU); the port's wrapper runs its plain version, which it takes only
because the tensors lie on the CPU.  Tolerance 2e-5: both sides compute in
fp32 and differ only in summation order.  The CUDA kernel itself is held
against the plain version on the card (marker ``gpu``; chip_smoke.py does
the same at the serving shapes).

The gradient: the port's autograd gradients (its ``_attention_backward``)
against ``jax.vjp`` of the JAX function (its ``custom_vjp``, whose backward
is XLA's vjp of the dense reference), within 1e-5 of each gradient's
largest magnitude: both compute in fp32 and differ only in summation order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops.pallas_kernels import flash_attention as jax_flash

from mxnet_tpu_torch.ops import _build, contrib
from mxnet_tpu_torch.ops import flash_attention as fa

TOL = 2e-5


def _qkv(b=2, h=2, t=256, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype("float32") for _ in range(3)]


@pytest.mark.parametrize("causal,t", [(False, 256), (True, 256),
                                      (True, 200), (False, 200)])
def test_flash_matches_jax(causal, t):
    """(2,2,256,64) both modes, causal padded T=200, and non-causal T=200
    (where JAX takes its dense fallback and the port's kernel masks)."""
    q, k, v = _qkv(t=t)
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal, None,
                               128, 128, True))
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    assert out.shape == (2, 2, t, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_flash_contrib_surface_matches_jax():
    q, k, v = _qkv(b=1, h=1, t=128)
    ref = mx.nd.contrib.flash_attention(*map(mx.nd.array, (q, k, v)))
    out = contrib.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref.asnumpy(), rtol=TOL,
                               atol=TOL)
    # MXNet-style string attributes reach the function
    causal = contrib.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal="True", scale="0.5")
    expect = fa._reference(*map(torch.from_numpy, (q, k, v)), True, 0.5)
    torch.testing.assert_close(causal, expect, rtol=0, atol=0)


def test_cpu_path_launches_nothing():
    q, k, v = map(torch.from_numpy, _qkv(b=1, h=1, t=64))
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before


def test_mixed_devices_raise():
    q, k, v = map(torch.from_numpy, _qkv(b=1, h=1, t=64))
    with pytest.raises(ValueError, match="all lie on the CPU"):
        fa.flash_attention(q, k.to("meta"), v)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("causal,t", [(False, 128), (True, 128),
                                      (True, 77), (False, 256)])
def test_flash_gradient_matches_jax_vjp(causal, t):
    """T=128 and 256 take the Pallas path in the JAX function (interpret
    mode); causal T=77 is ragged (JAX pads it, the port masks it)."""
    q, k, v = _qkv(t=t, seed=3)
    g = np.random.RandomState(4).randn(*q.shape).astype("float32")
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, None, 128,
                                                  128, True),
                       *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    calls = fa.flash_attention.backward_calls
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(g))
    assert fa.flash_attention.backward_calls == calls + 1
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               rtol=TOL, atol=TOL)
    for port, r in zip((tq.grad, tk.grad, tv.grad), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(port.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


def test_backward_does_not_call_reference(monkeypatch):
    """The forward on a CPU tensor is ``_reference``; the backward is
    ``_attention_backward`` alone, which recomputes P from q and k itself
    (on the card, the kernel launch stays the only attention forward)."""
    calls = []
    real = fa._reference
    monkeypatch.setattr(fa, "_reference",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(b=1, h=2, t=64))
    out = fa.flash_attention(q, k, v, causal=True)
    assert len(calls) == 1
    out.sum().backward()
    assert len(calls) == 1
    assert all(x.grad is not None and x.grad.abs().sum() > 0
               for x in (q, k, v))


def test_no_graph_without_grad():
    """Inputs that take no gradient, or grad mode off, run the forward
    alone: no autograd node, as the served path needs."""
    q, k, v = map(torch.from_numpy, _qkv(b=1, h=1, t=32))
    assert fa.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None
