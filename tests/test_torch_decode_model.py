"""The port's decode math against the JAX package's, on the CPU.

At ``tests/test_decode.py``'s size (``decode_tiny`` cut to 32 units, 2
heads, vocab 61, ``max_length=32``, page size 8), with the JAX block's
weights carried into the port through a ``.params`` file:

- ``rowdot`` (both orientations of ``w``) within 1e-6 of the largest
  magnitude; the int8 and fp8 quantizers' codes and sidecars bit for bit;
- ``prefill_math``, ``step_math`` over fp32, int8 and fp8 pools, and
  ``verify_math`` within 1e-5 of the largest magnitude (the two packages
  sum in other orders), every untouched pool entry bit for bit;
- the sampler: JAX's ``fold_in``/``uniform`` stream bit for bit, greedy
  tokens equal, sampled tokens equal on these logits;
- greedy ``generate`` through the port's ``DecodeSession`` equals the JAX
  package's ``DecodeSession`` for 4 prompts.

The port's own bitwise contracts (solo against continuous, shared against
cold, speculative against plain) are in ``test_torch_decode.py``.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.serving import decode as jdec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.ops.rowdot import rowdot
from mxnet_tpu_torch.serving import decode as dec
from mxnet_tpu_torch.serving.decode import sampling

VOCAB, UNITS, HEADS, MAXLEN, PAGE = 61, 32, 2, 32, 8
D = UNITS // HEADS


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        f"{what}: {err:.3e} > {tol} x {np.abs(want).max():.3e}"


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """The JAX block with seeded weights (scale 0.5, so that greedy tokens
    vary), and the port's block loaded from its ``.params`` file."""
    jnet = jdec.get_decode_model("decode_tiny", vocab_size=VOCAB,
                                 max_length=MAXLEN, units=UNITS,
                                 num_heads=HEADS)
    jnet.initialize()
    rng = np.random.RandomState(3)
    for name in jnet._param_order:
        p = jnet._reg_params[name]
        p.set_data(jmx.nd.array(
            (rng.randn(*p.shape) * 0.5).astype("float32")))
    path = str(tmp_path_factory.mktemp("decode") / "lm.params")
    jnet.save_parameters(path)
    net = dec.get_decode_model("decode_tiny", vocab_size=VOCAB,
                               max_length=MAXLEN, units=UNITS,
                               num_heads=HEADS)
    net.load_parameters(path, ctx=mx.cpu())
    assert net._param_order == jnet._param_order
    jp = jnet._params_dict(jnet.param_leaves())
    p = net._params_dict(net.param_leaves())
    for name in net._param_order:
        np.testing.assert_array_equal(p[name].numpy(),
                                      np.asarray(jp[name]))
    return jnet, jp, net, p


# ---------------------------------------------------------------- rowdot
def test_rowdot_matches_jax_both_orientations():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 32).astype("float32")
    w = rng.randn(32, 48).astype("float32")
    b = rng.randn(48).astype("float32")
    want = np.asarray(jdec.rowdot(jnp.asarray(x), jnp.asarray(w)))
    _close(rowdot(torch.from_numpy(x), torch.from_numpy(w)), want, 1e-6,
           "rowdot")
    _close(rowdot(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(b)), want + b, 1e-6, "rowdot + bias")
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    got = rowdot(torch.from_numpy(x), wt.t())
    _close(got, want, 1e-6, "rowdot over a transposed view")
    assert rowdot.launches == 0                  # the CPU runs no kernel


# ------------------------------------------------------------ quantizers
def _rows(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 7, 2, 16) * 3).astype("float32")
    x[1, 2] = 0.0                                # an all-zero row
    x[2, 3, 0, :4] = [0.5, -0.5, 1.5, 2.5]       # halves: ties to even
    return x


def test_int8_quantizer_codes_bitwise():
    x = _rows()
    jq, js, jm = jdec.kv_quantize_rows(jnp.asarray(x))
    q, s, m = dec.kv_quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        dec.kv_dequantize(q, s, m).numpy(),
        np.asarray(jdec.kv_dequantize(jq, js, jm)))


def test_fp8_quantizer_codes_bitwise():
    x = _rows(1)
    jq, js = jdec.kv_quantize_rows_fp8(jnp.asarray(x))
    q, s = dec.kv_quantize_rows_fp8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view("uint8"))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dec.kv_dequantize_fp8(q, s).numpy(),
        np.asarray(jdec.kv_dequantize_fp8(jq, js)))


# -------------------------------------------------------- model functions
def test_prefill_math_matches_jax(nets):
    jnet, jp, net, p = nets
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, VOCAB, (3, 16)).astype("int32")
    lengths = np.array([16, 5, 1], "int32")
    jl, jkv = jax.jit(jnet.prefill_math)(jp, tokens, lengths)
    logits, kv = net.prefill_math(p, torch.from_numpy(tokens),
                                  torch.from_numpy(lengths))
    _close(logits, jl, 1e-5, "prefill logits")
    _close(kv, jkv, 1e-5, "prefill K/V")
    # the block's own forward (the NDArray path) gives the same
    out = net(mx.nd.array(tokens, dtype="int32", ctx=mx.cpu()),
              mx.nd.array(lengths, dtype="int32", ctx=mx.cpu()))
    np.testing.assert_array_equal(out[0].asnumpy(), logits.numpy())


N_PAGES, N_TAB = 12, 4


def _pools(kind, seed=2):
    """Seeded pools (every entry written, the trash page included) in the
    JAX cache's layout: fp32 values, or values quantized by the JAX
    quantizer with their sidecars."""
    rng = np.random.RandomState(seed)
    shape = (2, N_PAGES, PAGE, HEADS, D)
    k = rng.randn(*shape).astype("float32")
    v = rng.randn(*shape).astype("float32")
    if kind == "fp32":
        return [k, v]
    if kind == "int8":
        kq, ks, km = jdec.kv_quantize_rows(jnp.asarray(k))
        vq, vs, vm = jdec.kv_quantize_rows(jnp.asarray(v))
        return [np.asarray(t) for t in (kq, vq, ks, km, vs, vm)]
    kq, ks = jdec.kv_quantize_rows_fp8(jnp.asarray(k))
    vq, vs = jdec.kv_quantize_rows_fp8(jnp.asarray(v))
    return [np.asarray(t) for t in (kq, vq, ks, vs)]


def _torch_pool(a):
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view("uint8").copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _pool_numpy(t):
    if t.dtype == torch.float8_e4m3fn:
        return dec.kv_dequantize_fp8(t, torch.ones(t.shape[:-2])).numpy()
    return t.float().numpy()


def _jax_numpy(a):
    return np.asarray(jnp.asarray(a).astype("float32"))


# rows 0-2 live, row 3 padding (token 0, position 0, all-trash table)
TABLES = np.array([[3, 7, 1, 0], [2, 5, 8, 9], [11, 4, 6, 10],
                   [0, 0, 0, 0]], "int32")
POSITIONS = np.array([13, 2, 25, 0], "int32")


def _hold_pools(got, want, touched, kind, what):
    """Every pool entry equals the JAX result bit for bit except the rows
    this call wrote (``touched``: (page, offset) pairs).  Those hold values
    the two packages computed in another order: fp32 values and every
    sidecar within 1e-5 of the largest magnitude, int8 codes within one
    step, fp8 codes within one step of their 3-bit mantissa."""
    for i, (g, w) in enumerate(zip(got, want)):
        g = _pool_numpy(g)
        w = _jax_numpy(w)
        mask = np.ones(g.shape[:3], bool)
        for page, off in touched:
            mask[:, page, off] = False
        np.testing.assert_array_equal(g[mask], w[mask],
                                      err_msg=f"{what} pool {i}")
        new_g, new_w = g[~mask], w[~mask]
        if i >= 2 or kind == "fp32":
            _close(new_g, new_w, 1e-5, f"{what} pool {i} new rows")
        elif kind == "int8":
            assert np.abs(new_g - new_w).max() <= 1.0, what
        else:
            assert (np.abs(new_g - new_w)
                    <= np.abs(new_w) / 8 + 2.0 ** -9).all(), what


@pytest.mark.parametrize("kind", ["fp32", "int8", "fp8"])
def test_step_math_matches_jax(nets, kind):
    jnet, jp, net, p = nets
    pools = _pools(kind)
    tokens = np.array([5, 17, 60, 0], "int32")
    fn = jax.jit(functools.partial(jnet.step_math, page_size=PAGE))
    jquant = [jnp.asarray(a) for a in pools[2:]] or None
    jout = fn(jp, tokens, POSITIONS, TABLES, jnp.asarray(pools[0]),
              jnp.asarray(pools[1]), quant=jquant)
    tp = [_torch_pool(a) for a in pools]
    out = net.step_math(p, torch.from_numpy(tokens),
                        torch.from_numpy(POSITIONS),
                        torch.from_numpy(TABLES), tp[0], tp[1], PAGE,
                        quant=tp[2:] or None)
    _close(out[0], jout[0], 1e-5, f"{kind} step logits")
    assert all(a is b for a, b in zip(out[1:], tp))   # updated in place
    touched = [(TABLES[r, POSITIONS[r] // PAGE], POSITIONS[r] % PAGE)
               for r in range(4)]
    _hold_pools(out[1:], jout[1:], touched, kind, f"{kind} step")


def test_verify_math_matches_jax(nets):
    jnet, jp, net, p = nets
    pools = _pools("fp32", seed=4)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, VOCAB, (4, 4)).astype("int32")
    n_draft = np.array([3, 1, 3, 0], "int32")
    positions = np.array([13, 2, 29, 0], "int32")     # row 2 runs off
    fn = jax.jit(functools.partial(jnet.verify_math, page_size=PAGE))
    jout = fn(jp, tokens, positions, n_draft, TABLES,
              jnp.asarray(pools[0]), jnp.asarray(pools[1]))
    tp = [_torch_pool(a) for a in pools]
    out = net.verify_math(p, torch.from_numpy(tokens),
                          torch.from_numpy(positions),
                          torch.from_numpy(n_draft),
                          torch.from_numpy(TABLES), tp[0], tp[1], PAGE)
    _close(out[0], jout[0], 1e-5, "verify logits")
    touched = set()
    for r in range(4):
        for j in range(4):
            pos = positions[r] + j
            ok = j <= n_draft[r] and pos // PAGE < N_TAB
            touched.add((TABLES[r, pos // PAGE] if ok else 0, pos % PAGE))
    _hold_pools(out[1:], jout[1:], sorted(touched), "fp32", "verify")


def test_paged_attention_plain_is_the_gather_and_einsum():
    """The kernel's plain version against the JAX step's ``attend`` on the
    same pools, and its fp8 route against the dequantised context."""
    rng = np.random.RandomState(6)
    pools = _pools("fp8", seed=7)
    q = rng.randn(4, 2, HEADS, D).astype("float32")
    tp = [_torch_pool(a) for a in pools]
    got = pa.paged_attention(torch.from_numpy(q), tp[0][0], tp[1][0],
                             torch.from_numpy(TABLES),
                             torch.from_numpy(POSITIONS),
                             [tp[2][0], tp[3][0]])
    kg = np.asarray(jdec.kv_dequantize_fp8(
        jnp.asarray(pools[0][0])[TABLES], jnp.asarray(pools[2][0])[TABLES]))
    vg = np.asarray(jdec.kv_dequantize_fp8(
        jnp.asarray(pools[1][0])[TABLES], jnp.asarray(pools[3][0])[TABLES]))
    kg = kg.reshape(4, N_TAB * PAGE, HEADS, D)
    vg = vg.reshape(4, N_TAB * PAGE, HEADS, D)
    s = np.einsum("bqhd,blhd->bhql", q, kg)
    pos = POSITIONS[:, None] + np.arange(2)[None]
    mask = np.arange(N_TAB * PAGE)[None, None] <= pos[:, :, None]
    s = np.where(mask[:, None], s, -1e30)
    e = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhql,blhd->bqhd", e / e.sum(-1, keepdims=True), vg)
    _close(got, want, 1e-5, "paged attention (fp8)")
    assert pa.paged_attention.launches == 0


# ---------------------------------------------------------------- sampler
def test_sampler_stream_is_jax_bit_for_bit(nets):
    jnet = nets[0]
    keys = np.array([[0, 7], [3, 0xdeadbeef], [1 << 31, 5]], "uint32")
    steps = np.array([0, 4, 11], "int32")
    folded = sampling.fold_in(keys, steps)
    for r in range(3):
        jk = jax.random.fold_in(keys[r], steps[r])
        np.testing.assert_array_equal(folded[r], np.asarray(jk))
        want = jax.random.uniform(jk, (VOCAB,), minval=1e-7, maxval=1.0)
        got = sampling.uniform(folded[r:r + 1], VOCAB, "cpu")[0]
        np.testing.assert_array_equal(got.numpy().view("uint32"),
                                      np.asarray(want).view("uint32"))
    rng = np.random.RandomState(8)
    logits = (rng.randn(6, VOCAB) * 2).astype("float32")
    keys6 = rng.randint(0, 2 ** 31, (6, 2)).astype("uint32")
    steps6 = rng.randint(0, 20, 6).astype("int32")
    temps = np.array([0.0, 0.7, 1.0, 0.0, 1.3, 0.9], "float32")
    want = np.asarray(jax.jit(jnet.sample_math)(logits, keys6, steps6,
                                                temps))
    got = sampling.sample(torch.from_numpy(logits), keys6, steps6, temps)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = sampling.sample(torch.from_numpy(logits), keys6, steps6,
                             np.zeros(6, "float32"))
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


# ------------------------------------------------------------- generation
def test_greedy_generate_matches_jax_session(nets):
    jnet, _, net, _ = nets
    prompts = [[5, 9, 2], [1, 2, 3, 4, 5, 6, 7], [60, 1], [33] * 8]
    kw = dict(batch_buckets=(1,), seq_buckets=(8,), page_size=PAGE)
    jsess = jdec.DecodeSession(jnet, **kw)
    try:
        want = [jsess.generate(pr, max_new_tokens=6, seed=i,
                               timeout=120).token_ids
                for i, pr in enumerate(prompts)]
    finally:
        jsess.close(drain=False, timeout=10.0)
    with mx.cpu():
        sess = dec.DecodeSession(net, **kw)
    try:
        got = [sess.generate(pr, max_new_tokens=6, seed=i,
                             timeout=120).token_ids
               for i, pr in enumerate(prompts)]
    finally:
        sess.close(drain=False, timeout=10.0)
    assert got == want
    assert len({t for toks in got for t in toks}) > 3     # not degenerate
