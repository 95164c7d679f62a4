"""The port's CUDA flash-attention kernel against its plain version, on the
card, and the gradient of the kernel route against the plain version's.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package, so on a machine with the card it
runs without them:

    python -m pytest --noconftest -q tests/test_torch_flash_attention_gpu.py

TF32 is switched off so that the fp32 plain version is true fp32.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as fa


def _qkv(b, h, t, d, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype("float32") for _ in range(3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_against_plain(q, k, v, causal):
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = fa._reference(q.float(), k.float(), v.float(), causal,
                        q.shape[-1] ** -0.5)
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)


# T at and around the 16-row warp tile and the 64-row K tile (1, 15, 17,
# 65, 513), D at and off the mma depths (8, 30, 40, 100, 128), BERT's
# bucket and its maximum length (512)
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 12, 128, 64), (2, 2, 200, 64),
                                   (2, 2, 256, 128), (1, 3, 77, 40),
                                   (1, 2, 50, 30), (2, 3, 1, 64),
                                   (1, 2, 15, 8), (2, 2, 17, 100),
                                   (1, 3, 65, 128), (1, 2, 513, 64),
                                   (8, 12, 512, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_matches_plain_on_card(cuda, shape, causal, dtype):
    """fp32 within 1e-4; bf16/fp16 against the plain version in fp32 on the
    same rounded inputs, within the output's own rounding (2e-2)."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in _qkv(*shape))
    _check_against_plain(q, k, v, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["large_scores", "distinct_v"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_hard_inputs_on_card(cuda, inputs, causal, dtype):
    """``large_scores``: q and k scaled by 8, so scores reach ~+-100 and the
    online softmax rescales often, and the low TF32 parts carry real
    weight.  ``distinct_v``: V[row, col] = cos(0.7 row + 1.3 col), a value
    per key and column, so a key that meets the wrong V row in P V shows.
    fp32 is also held within 1e-4 of the same attention in float64, where
    the plain fp32 version's own rounding does not count."""
    shape = (2, 3, 200, 64)
    q, k, v = _qkv(*shape, seed=3)
    if inputs == "large_scores":
        q, k = 8 * q, 8 * k
    else:
        rows = np.arange(shape[2])[:, None]
        cols = np.arange(shape[3])[None, :]
        v = np.broadcast_to(np.cos(0.7 * rows + 1.3 * cols),
                            shape).astype("float32")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(x)).to(cuda, dt)
               for x in (q, k, v))
    _check_against_plain(q, k, v, causal)
    if dtype == "float32":
        t = shape[2]
        s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) \
            * shape[3] ** -0.5
        if causal:
            above = torch.ones(t, t, dtype=torch.bool, device=cuda).triu(1)
            s = s.masked_fill(above, -np.inf)
        exact = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1),
                             v.double())
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(out.double(), exact, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_reruns_bitwise_on_card(cuda, dtype):
    """No atomics and a fixed order of every sum: the same bits twice."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in _qkv(8, 12, 128, 64))
    for causal in (False, True):
        first = fa.flash_attention(q, k, v, causal=causal)
        second = fa.flash_attention(q, k, v, causal=causal)
        assert torch.equal(first, second)


@pytest.mark.gpu
def test_kernel_takes_unaligned_inputs_on_card(cuda):
    """A contiguous view 4 bytes off a 16-byte boundary takes the kernel's
    one-element load path and gives the same answer."""
    shape = (2, 2, 64, 64)
    n = int(np.prod(shape))
    q, k, v = (torch.from_numpy(np.concatenate([[0.0], x.ravel()])
                                .astype("float32")).to(cuda)[1:].view(shape)
               for x in _qkv(*shape))
    assert q.data_ptr() % 16 and q.numel() == n
    out = fa.flash_attention(q, k, v)
    ref = fa._reference(q, k, v, False, 64 ** -0.5)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_kernel_rejects_bad_input_on_card(cuda):
    q = torch.zeros(1, 1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                           q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), q.double(), q.double())
    wide = torch.zeros(1, 1, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="D=160"):
        fa.flash_attention(wide, wide, wide)


# half an ulp of the largest element, relative: the gradient is computed in
# fp32 from the same inputs and rounded once to the input dtype
_HALF_ULP = {"float32": 0.0, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def _check_gradient_against_plain(q, k, v, g, causal):
    """dQ, dK, dV of the kernel route (leaf inputs, ``backward``) against
    the gradients of the plain version in fp32 on the same inputs: within
    1e-4 of each tensor's largest magnitude, plus half an ulp of it for
    bf16/fp16."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    launches = fa.flash_attention.launches
    calls = fa.flash_attention.backward_calls
    out = fa.flash_attention(*leaves, causal=causal)
    out.backward(g)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    assert fa.flash_attention.backward_calls == calls + 1
    plain = [x.detach().float().requires_grad_() for x in (q, k, v)]
    fa._reference(*plain, causal, q.shape[-1] ** -0.5).backward(g.float())
    tol = 1e-4 + _HALF_ULP[str(q.dtype)[6:]]
    for got, ref in zip(leaves, plain):
        assert got.grad is not None and got.grad.dtype == q.dtype
        torch.testing.assert_close(got.grad.float(), ref.grad, rtol=0,
                                   atol=tol * ref.grad.abs().max().item())
    return [x.grad for x in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 12, 128, 64), (2, 2, 200, 64),
                                   (1, 3, 77, 40), (2, 2, 256, 128),
                                   (1, 2, 513, 64), (8, 12, 512, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_gradient_matches_plain_on_card(cuda, shape, causal, dtype):
    """The flash route on CUDA carries a gradient (leaf q, k, v get
    ``.grad``), and it is the plain version's: BERT's bucket, its maximum
    length, ragged T and D."""
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(x).to(cuda, dt)
                  for x in _qkv(*shape) + _qkv(*shape, seed=2)[:1])
    _check_gradient_against_plain(q, k, v, g, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_gradient_reruns_bitwise_on_card(cuda, dtype):
    """The backward's products and reductions run in a fixed order: the
    same bits twice."""
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(x).to(cuda, dt)
                  for x in _qkv(8, 12, 128, 64) + _qkv(8, 12, 128, 64,
                                                       seed=2)[:1])
    for causal in (False, True):
        first = _check_gradient_against_plain(q, k, v, g, causal)
        second = _check_gradient_against_plain(q, k, v, g, causal)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_gradient_reaches_bert_projection_on_card(cuda):
    """Fault repaired: under ``autograd.record()`` the unmasked BERT layer
    (the flash route) gives its QKV projection the gradient of the same
    layer, same weights, on the CPU plain path."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.models.bert import MultiHeadAttention

    x = torch.from_numpy(np.random.RandomState(3).randn(2, 128, 64)
                         .astype("float32"))
    card = MultiHeadAttention(64, 4, device=cuda)
    card.initialize(generator=torch.Generator(device=cuda).manual_seed(0))
    host = MultiHeadAttention(64, 4, device="cpu")
    host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    launches = fa.flash_attention.launches
    grads = []
    for cell, dev in ((card, cuda), (host, torch.device("cpu"))):
        with autograd.record():
            out = cell(x.to(dev))
        autograd.backward(out)
        grads.append(cell.qkv.weight.grad.cpu())
    assert fa.flash_attention.launches == launches + 1
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=1e-4 * grads[1].abs().max().item())
