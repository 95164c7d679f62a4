"""Decode serving's kernels and contracts on the card.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package, so on a machine with the card it
runs without them:

    python -m pytest --noconftest -q -m gpu tests/test_torch_decode_gpu.py

- ``rowdot`` (``csrc/rowdot.cu``) against its plain version at GPT-2
  small's widths and at lengths that are not multiples of 64 or of 4,
  both orientations of ``w``, with and without bias, in both regimes
  (split up to 40 rows, tiled above), one launch a call; its row
  invariance: row ``r`` of an ``N``-row call equals a 1-row call bit for
  bit, N = 2..8, 40, 1024 and 4096; every split and the tiled regime
  forced on the same inputs give the same bits;
- the paged attention kernel (``csrc/paged_attention.cu``) against its
  plain version over fp32, int8 and fp8 pools, step and verify (K = 4),
  D 64, 32, 128 and 24, at contexts of one key, on and one past a 64-key
  chunk's edge, a verify crossing into the next chunk and the full
  1024-key table, one launch a call; its invariance to batch
  composition, physical page placement and the verify's query count; two
  calls on two streams bit for bit, the tickets left at zero;
- the flash prefill's rows invariant to the seq bucket and the batch,
  ``F.layer_norm``'s rows to the row count;
- solo against continuous decode, greedy and sampled, bit for bit.

TF32 is switched off: the plain versions are true fp32.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.ops import rowdot as rd
from mxnet_tpu_torch.serving import decode as dec

GPT2 = dict(units=768, heads=12, hidden=3072, vocab=50257)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0, device="cuda"):
    return torch.from_numpy((rng.randn(*shape) * scale).astype("float32")
                            ).to(device)


def _plain_rowdot(x, w):
    """The plain version over row chunks of about 1.2 GB of broadcast."""
    rows = max(1, int(3e8 // (x.shape[1] * w.shape[1])))
    return torch.cat([rd._reference(x[i:i + rows], w)
                      for i in range(0, x.shape[0], rows)])


def _rowdot_case(rng, u, v, trans, bias):
    w = _randn(rng, v, u, scale=0.02).t() if trans else \
        _randn(rng, u, v, scale=0.02)
    return w, (_randn(rng, v) if bias else None)


def _held(got, want, tol, what):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


# ------------------------------------------------------------------- rowdot
# U of 768 and 3072 (GPT-2 small), and lengths that are not multiples of
# 64 or of 4 (the partial last chunk, the 4-byte copies)
ROWDOT_SHAPES = [(768, 2304, False), (768, 768, False), (768, 3072, False),
                 (3072, 768, False), (768, 50257, True), (256, 512, True),
                 (30, 7, False), (33, 65, True), (100, 300, False),
                 (100, 130, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("u, v, trans", ROWDOT_SHAPES)
def test_rowdot_matches_plain(cuda, u, v, trans, bias):
    """Both regimes (split up to 40 rows, tiled above) against the plain
    version, one launch a call."""
    rng = np.random.RandomState(u + v)
    w, b = _rowdot_case(rng, u, v, trans, bias)
    for n in (1, 3, 8, 40, 41, 300):
        x = _randn(rng, n, u)
        before = rd.rowdot.launches
        y = rd.rowdot(x, w, b)
        torch.cuda.synchronize()
        assert rd.rowdot.launches == before + 1
        want = _plain_rowdot(x, w)
        _held(y, want if b is None else want + b, 1e-5,
              f"rowdot n={n} u={u} v={v}")


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("u, v, trans", ROWDOT_SHAPES)
def test_rowdot_rows_are_batch_invariant(cuda, u, v, trans, bias):
    """Rows of N = 2..8 (split), 40 (split), 1024 and 4096 (tiled) calls
    are bit for bit the 1-row calls (split), one launch each."""
    rng = np.random.RandomState(1)
    w, b = _rowdot_case(rng, u, v, trans, bias)
    x = _randn(rng, 4096, u)
    picks = list(range(8)) + [39, 100, 1023, 2049, 4095]
    solo = {r: rd.rowdot(x[r:r + 1], w, b) for r in picks}
    for n in (*range(2, 9), 40, 1024, 4096):
        before = rd.rowdot.launches
        y = rd.rowdot(x[:n], w, b)
        assert rd.rowdot.launches == before + 1
        for r in picks:
            if r < n:
                assert torch.equal(y[r:r + 1], solo[r]), (n, r)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8, 40])
@pytest.mark.parametrize("u, v, trans", [(768, 2304, False),
                                         (3072, 768, False),
                                         (768, 50257, True),
                                         (100, 130, True), (30, 7, False)])
def test_rowdot_every_plan_is_bitwise_the_same(cuda, n, u, v, trans):
    """Every split of the chunks (the fold by tickets across blocks) and
    the tiled regime give the same bits, and the chosen plan is the one
    reported; the tickets are left at zero."""
    rng = np.random.RandomState(3)
    w, b = _rowdot_case(rng, u, v, trans, True)
    x = _randn(rng, n, u)
    used = torch.zeros(2, dtype=torch.int32)
    want = rd._launch(x, w, b, 0, used)
    assert used[0].item() == 0                   # split regime
    chunks = (u + 63) // 64
    for plan in (1, 2, 3, 5, chunks, 2 * chunks, -1):
        got = rd._launch(x, w, b, plan, used)
        torch.cuda.synchronize()
        if plan < 0:
            assert used.tolist() == [1, 1]
        else:
            assert used[0].item() == 0
            assert 1 <= used[1].item() <= min(plan, chunks)
        assert torch.equal(got, want), plan
    assert all(not t[1].any() for t in rd._scratch.values())


# ----------------------------------------------------------- paged attention
def _pool_case(kind, b=8, heads=12, d=64, ps=16, n_tab=64, pages=None,
               seed=0):
    """Pools of one layer (every entry written) and page tables giving each
    row its own pages."""
    rng = np.random.RandomState(seed)
    pages = pages or b * n_tab + 1
    k = _randn(rng, pages, ps, heads, d)
    v = _randn(rng, pages, ps, heads, d)
    perm = rng.permutation(np.arange(1, pages))[:b * n_tab]
    tables = torch.from_numpy(perm.reshape(b, n_tab).astype("int32")).cuda()
    if kind == "fp32":
        return k, v, None, tables
    if kind == "int8":
        kq, ks, km = dec.kv_quantize_rows(k)
        vq, vs, vm = dec.kv_quantize_rows(v)
        return kq, vq, [ks, km, vs, vm], tables
    kq, ks = dec.kv_quantize_rows_fp8(k)
    vq, vs = dec.kv_quantize_rows_fp8(v)
    return kq, vq, [ks, vs], tables


# heads a width: GPT-2 small (64), decode_base (32), a wide and a ragged
# head (24: int8 and fp8 rows of 24 bytes take the kernel's plain loads)
PA_HEADS = {64: 12, 32: 8, 128: 4, 24: 6}


def _pa_positions(which, nq):
    """Rows of very different lengths in one call.  ``spread``: one key
    (p = 0) up to the full 1024-key table at the last query.  ``chunks``:
    contexts that end on a 64-key chunk's last key (63, 127), one key past
    it (64, 128), a verify whose queries cross into the next chunk (60),
    and the table's last key at the last query."""
    rows = {"spread": [0, 15, 16, 100, 511, 640, 1000, 1024 - nq],
            "chunks": [63, 64, 60, 0, 127, 128, 1024 - nq, 5]}[which]
    return torch.tensor(rows, dtype=torch.int32, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["spread", "chunks"])
@pytest.mark.parametrize("kind", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("nq", [1, 5])
@pytest.mark.parametrize("d", [64, 32, 128, 24])
def test_paged_attention_matches_plain(cuda, kind, nq, d, which):
    heads = PA_HEADS[d]
    k, v, quant, tables = _pool_case(kind, heads=heads, d=d, seed=nq + d)
    rng = np.random.RandomState(2)
    q = _randn(rng, 8, nq, heads, d, scale=d ** -0.5)
    positions = _pa_positions(which, nq)
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, k, v, tables, positions, quant)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1     # one launch a call
    _held(out, pa._reference(q, k, v, tables, positions, quant), 1e-5,
          f"paged attention {kind} nq={nq} d={d} {which}")
    assert all(not t[1].any() for t in pa._scratch.values())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("d", [64, 32])
def test_paged_attention_row_invariance(cuda, kind, d):
    """A row's bits do not depend on the batch around it, on where its
    pages lie, or on how many queries the call carries, at chunk edges
    too: contexts of one key, ending on a chunk's last key or one past
    it, a verify crossing into the next chunk, the full table."""
    heads = PA_HEADS[d]
    k, v, quant, tables = _pool_case(kind, b=8, heads=heads, d=d, n_tab=64,
                                     pages=600, seed=3)
    rng = np.random.RandomState(4)
    q = _randn(rng, 8, 5, heads, d, scale=d ** -0.5)
    pos = torch.tensor([3, 60, 63, 0, 120, 1019, 500, 64],
                       dtype=torch.int32, device="cuda")
    full = pa.paged_attention(q, k, v, tables, pos, quant)
    for r in range(8):
        one = pa.paged_attention(q[r:r + 1], k, v, tables[r:r + 1],
                                 pos[r:r + 1], quant)
        assert torch.equal(one, full[r:r + 1]), r
    perm = [5, 2, 0, 7, 1]
    mixed = pa.paged_attention(q[perm], k, v, tables[perm], pos[perm],
                               quant)
    assert torch.equal(mixed, full[perm])
    # the verify's query j equals a 1-query step at position pos + j, and
    # a 2-query verify's the same
    for j in range(5):
        step = pa.paged_attention(q[:, j:j + 1].contiguous(), k, v, tables,
                                  pos + j, quant)
        assert torch.equal(step, full[:, j:j + 1]), j
    two = pa.paged_attention(q[:, 3:5].contiguous(), k, v, tables, pos + 3,
                             quant)
    assert torch.equal(two, full[:, 3:5])
    # row 1's pages moved to other physical pages (copied with sidecars)
    free = [p for p in range(1, 600)
            if p not in set(tables.flatten().tolist())]
    moved = tables.clone()
    pools = [k, v] + list(quant or [])
    for slot in range(64):
        src, dst = int(tables[1, slot]), free[slot]
        for t in pools:
            bt = pa.pool_bytes(t)
            bt[dst] = bt[src]
        moved[1, slot] = dst
    again = pa.paged_attention(q, k, v, moved, pos, quant)
    assert torch.equal(again, full)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_paged_attention_two_streams_bitwise(cuda, kind):
    """Two calls in flight on two streams (each its own scratch) give the
    same bits as each other and as a call on the default stream, and
    leave every ticket at zero."""
    k, v, quant, tables = _pool_case(kind, seed=7)
    rng = np.random.RandomState(8)
    q = _randn(rng, 8, 5, 12, 64, scale=0.125)
    pos = _pa_positions("spread", 5)
    want = pa.paged_attention(q, k, v, tables, pos, quant)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append([pa.paged_attention(q, k, v, tables, pos, quant)
                         for _ in range(3)])
    torch.cuda.synchronize()
    for got in outs:
        for o in got:
            assert torch.equal(o, want)
    assert len(pa._scratch) >= 2
    assert all(not t[1].any() for t in pa._scratch.values())


# ---------------------------------------------------- prefill and LayerNorm
def _decode_base(vocab=512, seed=0):
    with mx.gpu(0):
        net = dec.get_decode_model("decode_base", vocab_size=vocab,
                                   max_length=128)
        net.initialize()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name in net._param_order:
            t = net._reg_params[name].tensor()
            t.copy_(torch.from_numpy(
                (rng.randn(*t.shape) * 0.1).astype("float32")))
    return net


@pytest.mark.gpu
def test_flash_prefill_rows_invariant_to_bucket_and_batch(cuda):
    net = _decode_base()
    p = net._params_dict(net.param_leaves())
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, 512, 37)

    def run(batch, seq, row):
        tok = np.zeros((batch, seq), "int32")
        tok[:] = rng.randint(0, 512, (batch, seq))     # other rows differ
        tok[row, :37] = prompt
        lengths = np.full((batch,), seq, "int32")
        lengths[row] = 37
        with torch.no_grad():
            logits, kv = net.prefill_math(
                p, torch.from_numpy(tok).cuda(),
                torch.from_numpy(lengths).cuda())
        return logits[row], kv[:, :, row, :37]

    from mxnet_tpu_torch.ops import flash_attention as fa
    before = fa.flash_attention.launches
    ref = run(1, 64, 0)
    assert fa.flash_attention.launches == before + 4     # one a layer
    for batch, seq, row in ((4, 64, 2), (1, 128, 0), (8, 128, 5)):
        got = run(batch, seq, row)
        assert torch.equal(got[0], ref[0]), (batch, seq)
        assert torch.equal(got[1], ref[1]), (batch, seq)


@pytest.mark.gpu
@pytest.mark.parametrize("u", [256, 768])
def test_layer_norm_rows_invariant_to_row_count(cuda, u):
    rng = np.random.RandomState(6)
    x = _randn(rng, 4096, u)
    g, b = _randn(rng, u), _randn(rng, u)
    full = dec.model._ln(x, g, b)
    for n in list(range(1, 9)) + [512, 2048]:
        assert torch.equal(dec.model._ln(x[:n], g, b), full[:n]), n
    assert torch.equal(dec.model._ln(x[1000:1001], g, b), full[1000:1001])


# --------------------------------------------------------------- contracts
@pytest.mark.gpu
def test_solo_and_continuous_tokens_bitwise(cuda):
    net = _decode_base(seed=1)
    reqs = [dict(prompt=list(np.random.RandomState(100 + i).randint(
        1, 512, 3 + (i * 7) % 40)), max_new_tokens=4 + i % 6,
        temperature=0.8 * (i % 2), seed=200 + i) for i in range(12)]
    sess = dec.DecodeSession(net, page_size=16, batch_buckets=(1, 2, 4, 8))
    try:
        solo = [sess.generate(timeout=120, **r).token_ids for r in reqs]
        sess.cache.drop_prefix_cache()
        futs = []

        def feed():
            for r in reqs:
                futs.append(sess.submit(**r))

        t = threading.Thread(target=feed)
        t.start()
        t.join(60)
        cont = [f.result(120).token_ids for f in futs]
    finally:
        sess.close(drain=False, timeout=30.0)
    assert solo == cont
    assert sess.cache.pages_in_use == 0
