"""The port's decode serving on the CPU: its own bitwise contracts.

The cases of ``tests/test_decode.py`` that need neither the fault sites,
the slots sanitizer nor a mesh (ROADMAP queue 1 items 9 and 10), run on
``mxnet_tpu_torch.serving.decode`` through its plain CPU path: paged KV
cache bookkeeping (slots, generations, refcounted prefix pages, LRU
reclaim, copy-on-write), the runtime's ladders and its zero
``decode.compile_miss`` after warm, continuous batching bitwise equal to
solo runs, shared prefixes bitwise equal to cold ones (fp32, int8 and fp8
pools), speculative decoding bitwise equal to plain decode, deadlines,
backpressure, the circuit breaker (driven by a failing step in place of
the ``decode.step`` fault site), a failing allocator, and ``close``.  The
contracts are the port's own, re-established inside it; the decode math
is held against the JAX package in ``test_torch_decode_model.py``.

Every wait here has a bound: each ``result`` a timeout, each ``close`` a
timeout.
"""
import threading
import time

import numpy as np
import pytest

import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.serving import RequestRejected
from mxnet_tpu_torch.serving.decode import (DecodeRuntime, DecodeScheduler,
                                            DecodeSession, GenerationResult,
                                            KVCacheExhausted, PagedKVCache,
                                            get_decode_model, pages_needed,
                                            seq_bucket_ladder)

VOCAB = 61


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """Every model, cache and runtime of this file lives on the CPU."""
    with mx.cpu():
        yield


def _net(**kw):
    """``test_decode.py``'s tiny model with seeded weights of a scale at
    which greedy tokens vary (the default ``normal`` init's 0.01 makes
    every greedy token the same)."""
    cfg = dict(vocab_size=VOCAB, max_length=32, units=32, num_heads=2)
    cfg.update(kw)
    net = get_decode_model("decode_tiny", **cfg)
    net.initialize()
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for name in net._param_order:
            t = net._reg_params[name].tensor()
            t.copy_(torch.from_numpy(
                (rng.randn(*t.shape) * 0.5).astype("float32")))
    return net


@pytest.fixture(autouse=True)
def _clean_bus():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


@pytest.fixture(scope="module")
def runtime():
    """One warmed runtime for the whole module."""
    net = _net()
    rt = DecodeRuntime(net, batch_buckets=(1, 2, 4), seq_buckets=(8, 16),
                       page_size=8)
    yield rt


@pytest.fixture(scope="module")
def tight_runtime():
    """Tiny KV pool (3 usable pages) for exhaustion-path tests."""
    net = _net()
    cache = PagedKVCache(net.num_layers, net.num_heads, net.head_dim,
                         page_size=4, num_pages=4, max_pages_per_seq=4,
                         max_slots=2)
    rt = DecodeRuntime(net, cache=cache, batch_buckets=(1, 2),
                       seq_buckets=(8,))
    yield rt


@pytest.fixture
def sched(runtime):
    s = DecodeScheduler(runtime)
    yield s
    s.close(drain=False, timeout=10.0)
    assert runtime.cache.pages_in_use == 0, "leaked KV pages"
    assert runtime.cache.slots_in_use == 0, "leaked KV slots"


def _prompt(i, lo=1, hi=14):
    rng = np.random.RandomState(1000 + i)
    return list(rng.randint(1, VOCAB, lo + (i * 3) % (hi - lo + 1)))


# ------------------------------------------------------------- page math
def test_pages_needed():
    # written positions = prompt + max_new - 1 (last token never re-encoded)
    assert pages_needed(3, 1, 8) == 1
    assert pages_needed(8, 1, 8) == 1
    assert pages_needed(8, 2, 8) == 2
    assert pages_needed(9, 8, 8) == 2
    assert pages_needed(1, 16, 8) == 2


def test_seq_bucket_ladder():
    assert seq_bucket_ladder(64) == (8, 16, 32, 64)
    assert seq_bucket_ladder(48) == (8, 16, 32, 48)
    assert seq_bucket_ladder(8) == (8,)
    assert seq_bucket_ladder(4) == (4,)
    with pytest.raises(ValueError):
        seq_bucket_ladder(0)


# ------------------------------------------------------------- KV cache
def test_kv_cache_alloc_free_generations():
    c = PagedKVCache(2, 2, 16, page_size=4, num_pages=9, max_pages_per_seq=4,
                     max_slots=3)
    assert c.usable_pages == 8 and c.context_length == 16
    a = c.alloc(3)
    b = c.alloc(4)
    assert c.pages_in_use == 7 and c.slots_in_use == 2
    assert 0 not in a.pages and 0 not in b.pages          # trash reserved
    assert not (set(a.pages) & set(b.pages))
    assert len(a.page_table) == 4 and a.page_table[3] == 0  # trash-padded
    with pytest.raises(KVCacheExhausted):
        c.alloc(2)                                         # 1 page free
    gen = c.generation(a.slot_id)
    c.free(a)
    assert c.generation(a.slot_id) == gen + 1              # bumped on free
    with pytest.raises(ValueError):
        c.free(a)                                          # double free
    c.free(b)
    assert c.pages_in_use == 0 and c.slots_in_use == 0
    with pytest.raises(ValueError):
        c.alloc(5)                                         # > max_pages_per_seq
    with pytest.raises(ValueError):
        PagedKVCache(2, 2, 16, num_pages=1)                # no room for trash


def test_kv_cache_slot_exhaustion():
    c = PagedKVCache(2, 2, 16, page_size=4, num_pages=9, max_pages_per_seq=2,
                     max_slots=1)
    a = c.alloc(1)
    with pytest.raises(KVCacheExhausted):
        c.alloc(1)                                         # slots, not pages
    c.free(a)
    c.alloc(1)


# ----------------------------------------------------------- runtime/ladder
def test_runtime_ladders_and_validation(runtime):
    assert runtime.batch_bucket_for(3) == 4
    assert runtime.seq_bucket_for(9) == 16
    with pytest.raises(ValueError):
        runtime.batch_bucket_for(5)
    with pytest.raises(ValueError):
        runtime.seq_bucket_for(17)
    net = runtime.block
    # cache context must fit the model's position table
    big = PagedKVCache(net.num_layers, net.num_heads, net.head_dim,
                       page_size=8, num_pages=17, max_pages_per_seq=8)
    with pytest.raises(ValueError):
        DecodeRuntime(net, cache=big, warm=False)
    small = PagedKVCache(net.num_layers, net.num_heads, net.head_dim,
                         page_size=8, num_pages=9, max_pages_per_seq=4,
                         max_slots=2)
    with pytest.raises(ValueError):                        # slots < max batch
        DecodeRuntime(net, cache=small, batch_buckets=(1, 4), warm=False)


def test_model_validation():
    with pytest.raises(ValueError):
        get_decode_model("decode_tiny", units=30, num_heads=4)


def test_default_cache_geometry_non_multiple_max_length():
    """Default geometry floors max_length/page_size: the derived context
    never exceeds the model's position table."""
    net = _net(max_length=20)
    rt = DecodeRuntime(net, batch_buckets=(1,), seq_buckets=(8,),
                       page_size=8, warm=False)
    assert rt.cache.context_length == 16                   # 20 // 8 pages
    with pytest.raises(ValueError):
        DecodeRuntime(net, batch_buckets=(1,), page_size=32, warm=False)


# ------------------------------------------------------------- submit plane
def test_submit_validation(sched):
    with pytest.raises(ValueError):
        sched.submit([])                                   # empty
    with pytest.raises(ValueError):
        sched.submit(list(range(1, 18)))                   # > max seq bucket
    with pytest.raises(ValueError):
        sched.submit([VOCAB + 3])                          # id out of range
    with pytest.raises(ValueError):
        sched.submit([1], max_new_tokens=0)
    with pytest.raises(ValueError):
        sched.submit([1] * 16, max_new_tokens=32)          # context overflow


def test_kv_never_fits_shed(tight_runtime):
    s = DecodeScheduler(tight_runtime)
    try:
        # 4 pages needed, 3 usable: could never be admitted
        with pytest.raises(RequestRejected) as ei:
            s.submit([1] * 8, max_new_tokens=8)
        assert ei.value.reason == "kv_exhausted"
    finally:
        s.close(drain=False, timeout=10.0)


def test_kv_exhaustion_waits_then_completes(tight_runtime):
    s = DecodeScheduler(tight_runtime)
    try:
        # each needs 2 of the 3 usable pages: the second waits for the
        # first eviction, then completes — and nothing leaks
        f1 = s.submit(_prompt(1, 4, 4), max_new_tokens=5, seed=1)
        f2 = s.submit(_prompt(2, 4, 4), max_new_tokens=5, seed=2)
        assert len(f1.result(60).token_ids) == 5
        assert len(f2.result(60).token_ids) == 5
    finally:
        s.close(drain=True, timeout=30.0)
    assert tight_runtime.cache.pages_in_use == 0


# ------------------------------------------------------------ generation
def test_generate_deterministic(sched):
    r1 = sched.generate([5, 9, 2], max_new_tokens=6, seed=7, timeout=60)
    r2 = sched.generate([5, 9, 2], max_new_tokens=6, seed=7, timeout=60)
    assert isinstance(r1, GenerationResult)
    assert r1.token_ids == r2.token_ids
    assert r1.finish_reason == "length" and len(r1.token_ids) == 6
    assert r1.prompt_len == 3 and r1.ttft_ms is not None
    t1 = sched.generate([5, 9, 2], max_new_tokens=8, temperature=0.9,
                        seed=11, timeout=60)
    t2 = sched.generate([5, 9, 2], max_new_tokens=8, temperature=0.9,
                        seed=11, timeout=60)
    assert t1.token_ids == t2.token_ids                    # same seed
    streams = [sched.generate([5, 9, 2], max_new_tokens=8, temperature=0.9,
                              seed=s, timeout=60).token_ids
               for s in (21, 22, 23)]
    assert len({tuple(s) for s in streams}) > 1            # seeds matter


def test_eos_stops_early(sched):
    ref = sched.generate([3, 1, 4, 1, 5], max_new_tokens=6, seed=0,
                         timeout=60).token_ids
    eos = ref[-1]
    idx = ref.index(eos)
    out = sched.generate([3, 1, 4, 1, 5], max_new_tokens=6, seed=0,
                         eos_id=eos, timeout=60)
    assert out.finish_reason == "eos"
    assert out.token_ids == ref[:idx + 1]


def test_cancelled_request_evicted(sched):
    # cancel while still queued behind a full batch: slot is never held
    blockers = [sched.submit(_prompt(i, 6, 6), max_new_tokens=16, seed=i)
                for i in range(4)]
    victim = sched.submit([1, 2], max_new_tokens=16)
    victim.cancel()
    [b.result(60) for b in blockers]
    assert victim.cancelled()


# ------------------------------------- THE no-recompile / parity contract
def test_continuous_batching_bitwise_parity_and_zero_misses(runtime):
    reqs = [dict(prompt=_prompt(i), max_new_tokens=3 + i % 6,
                 temperature=0.7 * (i % 3 == 0), seed=100 + i)
            for i in range(12)]
    s = DecodeScheduler(runtime)
    try:
        # solo reference: one request at a time (batch bucket 1)
        solo = [s.generate(timeout=120, **r).token_ids for r in reqs]
        # drop the prefix index the solo pass just populated: the
        # continuous pass must prefill cold so requests genuinely
        # overlap (full-prefix hits admit instantly and the batch can
        # drain between staggered arrivals) — and cold-vs-published is
        # exactly the parity this test exists to prove
        runtime.cache.drop_prefix_cache()
        telemetry.enable()
        telemetry.reset()
        futs = []

        def feed():
            for i, r in enumerate(reqs):
                futs.append(s.submit(**r))
                time.sleep(0.002 * (i % 4))

        t = threading.Thread(target=feed)
        t.start()
        t.join(60)
        assert not t.is_alive()
        cont = [f.result(120).token_ids for f in futs]
        snap = telemetry.snapshot()["counters"]
        telemetry.disable()
    finally:
        s.close(drain=False, timeout=10.0)
    for i, (a, b) in enumerate(zip(solo, cont)):
        assert a == b, f"request {i} diverged: solo={a} continuous={b}"
    assert not snap.get("decode.compile_miss"), snap
    assert snap.get("decode.joins", 0) >= 1          # genuinely continuous
    assert snap["decode.evictions"] == len(reqs)
    assert runtime.cache.pages_in_use == 0, "leaked KV pages"
    assert runtime.cache.slots_in_use == 0, "leaked KV slots"


# --------------------------------------------------------- shed/backpressure
def test_deadline_shed_while_waiting(sched):
    # 4 long sequences fill every batch row; a deadlined request behind
    # them expires at the next admission sweep instead of hanging
    blockers = [sched.submit(_prompt(i, 6, 6), max_new_tokens=20, seed=i)
                for i in range(4)]
    while sched.active() < 4 and not all(b.done() for b in blockers):
        time.sleep(0.001)
    late = sched.submit([1, 2, 3], max_new_tokens=4, deadline_ms=2)
    with pytest.raises(RequestRejected) as ei:
        late.result(60)
    assert ei.value.reason == "deadline"
    [b.result(120) for b in blockers]


def test_queue_backpressure_deadline(runtime):
    s = DecodeScheduler(runtime, queue_depth=1, start=False)
    try:
        s.submit([1, 2], max_new_tokens=2)
        with pytest.raises(RequestRejected) as ei:
            s.submit([3, 4], max_new_tokens=2, deadline_ms=30)
        assert ei.value.reason == "deadline"
    finally:
        s.close(drain=True, timeout=30.0)


def test_close_drain_false_rejects(runtime):
    s = DecodeScheduler(runtime, start=False)
    f = s.submit([1, 2, 3], max_new_tokens=4)
    s.close(drain=False)
    with pytest.raises(RequestRejected) as ei:
        f.result(5)
    assert ei.value.reason == "shutdown"
    with pytest.raises(RequestRejected):
        s.submit([1], max_new_tokens=1)
    assert runtime.cache.pages_in_use == 0


def test_close_drain_true_completes(runtime):
    s = DecodeScheduler(runtime, start=False)
    futs = [s.submit(_prompt(i), max_new_tokens=3, seed=i) for i in range(5)]
    s.close(drain=True, timeout=60.0)
    for f in futs:
        assert len(f.result(0).token_ids) == 3
    assert runtime.cache.pages_in_use == 0


# ------------------------------------------------------------ fault drills
# ------------------------------------------------------------- telemetry
def test_decode_telemetry_counters(runtime):
    telemetry.enable()
    s = DecodeScheduler(runtime)
    try:
        futs = [s.submit(_prompt(i), max_new_tokens=4, seed=i)
                for i in range(5)]
        [f.result(60) for f in futs]
    finally:
        s.close(drain=False, timeout=10.0)
    snap = telemetry.snapshot()
    c = snap["counters"]
    assert c["decode.requests"] == 5
    # an admission either prefills cold or skips via a full-prefix hit
    # (the module-scoped runtime's index may already know these prompts)
    assert c.get("decode.prefills", 0) + c.get("decode.prefill_skips", 0) \
        == 5
    assert c["decode.tokens"] == 20
    assert c["decode.evictions"] == 5
    assert c["decode.ttft_ms"] > 0
    assert c.get("decode.compile_miss") in (None, 0)
    assert "decode.kv_occupancy" in snap["gauges"]
    assert "decode.kv_bytes_per_token" in snap["gauges"]


# ------------------------------------------------ shared prefixes + int8
def _published_cache(**kw):
    """A small cache with one published 2-page prompt (chain + full
    entry, no tail: the prompt is page-aligned) and its donor slot."""
    cfg = dict(page_size=4, num_pages=12, max_pages_per_seq=4, max_slots=4)
    cfg.update(kw)
    c = PagedKVCache(2, 2, 16, **cfg)
    prompt = np.arange(1, 9, dtype="int32")            # 2 full pages
    donor = c.alloc(3, prompt=prompt)
    c.publish(donor, prompt, logits_row=np.zeros(7, "float32"))
    return c, prompt, donor


def test_prefix_sharing_refcounts_and_lifecycle():
    c, prompt, a = _published_cache()
    assert c.stats()["prefix_misses"] == 1
    b = c.alloc(3, prompt=prompt)                      # full hit
    assert b.shared_pages == 2
    assert b.pages[:2] == a.pages[:2]                  # acquired, not copied
    assert b.pages[2] not in a.pages
    assert b.prefix_logits is not None
    st = c.stats()
    assert st["prefix_hits"] == 1 and st["prefix_hit_rate"] == 0.5
    assert st["shared_pages"] >= 2
    # co-holder frees: shared pages survive for b AND for the index
    c.free(a)
    assert c.stats()["prefix_cached_pages"] == 2
    d = c.alloc(3, prompt=prompt)                      # still a hit
    assert d.shared_pages == 2
    c.free(b)
    c.free(d)
    # index pins keep the prefix warm with zero live slots
    assert c.pages_in_use == 0
    assert c.stats()["reclaimable_pages"] == 2
    c.drop_prefix_cache()
    assert c.stats()["prefix_cached_pages"] == 0
    assert c.stats()["reclaimable_pages"] == 0


def test_prefix_partial_chain_match_and_write_table():
    c, prompt, a = _published_cache()
    longer = np.concatenate([prompt, [9, 10, 11]]).astype("int32")
    b = c.alloc(4, prompt=longer)                      # chain match only
    assert b.shared_pages == 2 and b.prefix_logits is None
    wt = b.write_table()
    assert wt[:2] == [0, 0]                            # shared -> trash
    assert wt[2:4] == b.page_table[2:4] and 0 not in wt[2:4]
    c.free(b)
    c.free(a)


def test_prefix_cache_reclaimed_under_pressure():
    c, prompt, a = _published_cache()
    c.free(a)                                          # 2 pages pinned only
    assert c.stats()["reclaimable_pages"] == 2
    slots = [c.alloc(4), c.alloc(4)]                   # needs 8 of 11 usable
    big = c.alloc(3)                                   # forces reclaim
    assert c.stats()["prefix_cached_pages"] == 0       # index evicted LRU
    for s in slots + [big]:
        c.free(s)
    assert c.alloc(3, prompt=prompt).shared_pages == 0  # cold again
    # exhaustion message names the reclaimable count for pool sizing
    c2, _, a2 = _published_cache(num_pages=6)          # 5 usable, 3 held
    c2.free(a2)                                        # 2 pinned, 3 free... 
    c2.alloc(3)
    with pytest.raises(KVCacheExhausted) as ei:
        c2.alloc(4)                                    # > 2 free + 2 reclaim
    assert "reclaimable from the shared-prefix cache" in str(ei.value)


def _publish_and_free(c, prompt):
    """Publish ``prompt`` (chain + full entry) and leave its pages
    pinned-only; returns the donor's page list."""
    donor = c.alloc(len(prompt) // c.page_size, prompt=prompt)
    c.publish(donor, prompt, logits_row=np.zeros(7, "float32"))
    pages = list(donor.pages)
    c.free(donor)
    return pages


def test_prefix_hit_survives_reclaim_pressure():
    """Regression: a prefix-hit alloc under page pressure must never
    reclaim the pages it just matched — pre-fix the reclaimer freed the
    matched entry's pages (slot_refs still 0) and re-issued one as a
    writable fresh page, aliasing the shared prefix."""
    c = PagedKVCache(2, 2, 16, page_size=4, num_pages=8,
                     max_pages_per_seq=4, max_slots=4)
    p1 = np.arange(1, 9, dtype="int32")
    p2 = np.arange(101, 109, dtype="int32")
    _publish_and_free(c, p1)
    p2_pages = _publish_and_free(c, p2)
    blocker = c.alloc(3)                       # 0 free: hit must reclaim
    s = c.alloc(3, prompt=p2)                  # full hit on p2
    assert s.shared_pages == 2
    assert len(set(s.pages)) == len(s.pages)   # no page aliased
    assert s.pages[:2] == p2_pages[:2]         # matched pages kept intact
    # the matched entry survived reclaim (p1, the cold one, was evicted)
    assert c.stats()["prefix_cached_pages"] == 2
    c.free(s)
    c.free(blocker)
    assert c.alloc(3, prompt=p2).shared_pages == 2


def test_prefix_hit_exhausted_rolls_back():
    """When even reclaim can't free a fresh page, the hit path must roll
    back its acquisitions: the index stays intact and refcounts balance
    (pre-fix the matched pages were double-counted or freed)."""
    c = PagedKVCache(2, 2, 16, page_size=4, num_pages=6,
                     max_pages_per_seq=4, max_slots=4)
    p1 = np.arange(1, 9, dtype="int32")
    _publish_and_free(c, p1)
    blocker = c.alloc(3)                       # 0 free, 2 pinned by index
    with pytest.raises(KVCacheExhausted):
        c.alloc(3, prompt=p1)                  # hit, but no room for fresh
    assert c.stats()["prefix_cached_pages"] == 2   # index untouched
    c.free(blocker)
    s = c.alloc(3, prompt=p1)                  # retry after pressure: hit
    assert s.shared_pages == 2
    assert len(set(s.pages)) == len(s.pages)
    c.free(s)
    c.drop_prefix_cache()
    assert c.pages_in_use == 0
    assert all(r == 0 for r in c._slot_refs)   # refcounts balanced


def test_chain_eviction_unpublishes_suffix():
    """Evicting a chain link takes its whole suffix: links past a missing
    one can never match again, so leaving them pinned would strand pages
    in the index (pre-fix they held HBM invisibly)."""
    c = PagedKVCache(2, 2, 16, page_size=4, num_pages=6,
                     max_pages_per_seq=4, max_slots=4)
    prompt = np.arange(1, 13, dtype="int32")   # 3-page chain
    donor = c.alloc(3, prompt=prompt)
    c.publish(donor, prompt)                   # chain pins only, no entry
    c.free(donor)
    assert c.stats()["prefix_cached_pages"] == 3
    blocker = c.alloc(2)                       # 0 free
    s = c.alloc(1)                             # reclaim evicts the chain
    # the LRU head link went, and the rest of the chain went WITH it —
    # nothing is left pinned under unmatchable hashes
    assert c.stats()["prefix_cached_pages"] == 0
    assert c.stats()["reclaimable_pages"] == 0
    c.free(s)
    c.free(blocker)


def test_full_hit_keeps_chain_hot():
    """A full-entry hit must LRU-touch its chain hashes too: under later
    pressure the genuinely cold chain is evicted first, not the chain the
    hit just proved hot."""
    c = PagedKVCache(2, 2, 16, page_size=4, num_pages=10,
                     max_pages_per_seq=4, max_slots=4)
    p1 = np.arange(1, 9, dtype="int32")
    p2 = np.arange(101, 109, dtype="int32")
    _publish_and_free(c, p1)
    _publish_and_free(c, p2)
    hot = c.alloc(2, prompt=p1)                # full hit: p1 is hot now
    c.free(hot)
    blockers = [c.alloc(4), c.alloc(1)]        # 0 free
    trigger = c.alloc(2)                       # needs 2: evicts one chain
    c.free(trigger)
    for b in blockers:
        c.free(b)
    assert c.alloc(2, prompt=p1).shared_pages == 2   # hot chain survived
    assert c.alloc(2, prompt=p2).shared_pages == 0   # cold chain evicted


def test_copy_on_write_divergence():
    """Two slots share a published prefix whose tail page is partial: each
    acquirer gets a private tail copy at admission (the CoW moment), so
    writes diverge without touching the donor's or the index's pages."""
    c = PagedKVCache(2, 2, 16, page_size=4, num_pages=12,
                     max_pages_per_seq=4, max_slots=4)
    prompt = np.arange(1, 7, dtype="int32")            # 1 full page + tail 2
    a = c.alloc(3, prompt=prompt)
    c.publish(a, prompt, logits_row=np.zeros(7, "float32"))
    before = c.cow_copies
    b = c.alloc(3, prompt=prompt)                      # full hit
    assert c.cow_copies == before + 1                  # eager tail copy
    assert b.pages[0] == a.pages[0]                    # chain page shared
    assert b.pages[1] != a.pages[1]                    # tail privatized
    # ensure_writable on the shared chain page forces a private copy
    c.ensure_writable(b, 0)
    assert b.pages[0] != a.pages[0] and b.shared_pages == 0
    # ...and on an exclusively-owned page it is a no-op
    p1 = b.pages[1]
    c.ensure_writable(b, 1)
    assert b.pages[1] == p1
    c.free(a)
    c.free(b)


def test_int8_quantize_roundtrip_row_stable():
    from mxnet_tpu_torch.serving.decode import (kv_dequantize,
                                                kv_quantize_rows)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 7, 2, 16).astype("float32"))
    q, scale, mid = kv_quantize_rows(x)
    assert q.dtype == torch.int8 and scale.shape == (4, 7)
    err = np.abs(np.asarray(kv_dequantize(q, scale, mid)) - np.asarray(x))
    rng_span = np.asarray(x.amax(dim=(-2, -1)) - x.amin(dim=(-2, -1)))
    assert (err <= rng_span[..., None, None] / 254.0 + 1e-6).all()
    # row stability: a row's codes don't depend on its neighbors
    q2, s2, m2 = kv_quantize_rows(x[1:3])
    assert (np.asarray(q2) == np.asarray(q[1:3])).all()
    assert (np.asarray(s2) == np.asarray(scale[1:3])).all()
    # all-zero rows (trash page) dequantize to exactly 0.0
    qz, sz, mz = kv_quantize_rows(torch.zeros((1, 2, 16)))
    assert (np.asarray(kv_dequantize(qz, sz, mz)) == 0.0).all()


def test_int8_pool_geometry_doubles_admission():
    """The acceptance bar: at EQUAL pool bytes, int8 pools admit >= 2x the
    concurrent sequences of the fp32 baseline."""
    fp32 = PagedKVCache(2, 2, 16, page_size=8, num_pages=17,
                        max_pages_per_seq=4, max_slots=64)
    budget = fp32.usable_pages * fp32.page_bytes
    i8 = PagedKVCache(2, 2, 16, page_size=8,
                      num_pages=budget // (fp32.page_bytes // 3) + 1,
                      max_pages_per_seq=4, max_slots=64, kv_dtype="int8")
    assert i8.usable_pages * i8.page_bytes <= budget   # honest comparison
    assert i8.kv_bytes_per_token * 2 <= fp32.kv_bytes_per_token

    def max_admissible(cache, n_pages=2):
        held = []
        try:
            while True:
                held.append(cache.alloc(n_pages))
        except KVCacheExhausted:
            pass
        n = len(held)
        for s in held:
            cache.free(s)
        return n

    assert max_admissible(i8) >= 2 * max_admissible(fp32)


@pytest.fixture(scope="module")
def int8_session():
    net = _net()
    sess = DecodeSession(net, batch_buckets=(1, 2), seq_buckets=(8, 16),
                         page_size=8, kv_dtype="int8")
    yield sess
    sess.close(drain=False)


def test_int8_session_deterministic_and_shared(int8_session):
    sess = int8_session
    assert sess.cache.quantized and sess.stats()["kv_dtype"] == "int8"
    p = _prompt(3, 6, 12)
    r1 = sess.generate(p, max_new_tokens=5, temperature=0.8, seed=4,
                       timeout=120)
    r2 = sess.generate(p, max_new_tokens=5, temperature=0.8, seed=4,
                       timeout=120)
    # quantization is elementwise-deterministic: the shared-vs-cold
    # bitwise contract holds in int8 too (r2 rode the prefix index)
    assert r1.token_ids == r2.token_ids
    assert sess.stats()["prefix_hits"] >= 1
    assert sess.cache.pages_in_use == 0


def test_shared_vs_cold_bitwise_across_joins(runtime):
    """The sharing determinism bar: a request's tokens are bitwise
    identical whether its prefix was shared or cold, across continuous
    joins/evictions — checked against a prefix_sharing=False runtime."""
    sysp = _prompt(40, 10, 10)
    reqs = [dict(prompt=sysp + _prompt(50 + i, 1, 4),
                 max_new_tokens=3 + i % 4,
                 temperature=0.6 * (i % 2), seed=300 + i)
            for i in range(8)]
    # every third request repeats the bare system prompt with a fresh
    # seed: full-prefix hits that must still produce their own stream
    for i in (2, 5):
        reqs[i] = dict(prompt=sysp, max_new_tokens=4, temperature=0.9,
                       seed=400 + i)
    cold_rt = DecodeRuntime(runtime.block, batch_buckets=(1, 2, 4),
                            seq_buckets=(8, 16), page_size=8,
                            prefix_sharing=False)
    outs = {}
    for label, rt in (("shared", runtime), ("cold", cold_rt)):
        s = DecodeScheduler(rt)
        try:
            futs = []
            for i, r in enumerate(reqs):
                futs.append(s.submit(**r))
                time.sleep(0.002 * (i % 3))            # force joins
            outs[label] = [f.result(120).token_ids for f in futs]
        finally:
            s.close(drain=False, timeout=10.0)
    assert outs["shared"] == outs["cold"]
    assert cold_rt.cache.stats()["prefix_hits"] == 0   # genuinely cold
    assert runtime.cache.stats()["prefix_hits"] >= 2


def test_prefix_hit_skips_prefill_telemetry(runtime):
    telemetry.enable()
    s = DecodeScheduler(runtime)
    try:
        p = _prompt(60, 9, 9)
        s.generate(p, max_new_tokens=4, seed=1, timeout=60)
        # a successful prefix-hit admission counts as circuit-breaker
        # success exactly like a cold prefill does (max_new_tokens=1:
        # the request finishes at admission, so no decode step runs
        # that could reset the counter on the hit path's behalf)
        s._consecutive_failures = 1
        s.generate(p, max_new_tokens=1, seed=2, timeout=60)
        assert s._consecutive_failures == 0
    finally:
        s.close(drain=False, timeout=10.0)
    c = telemetry.snapshot()["counters"]
    assert c.get("decode.prefill_skips", 0) >= 1       # second skipped
    assert c.get("decode.prefix_hits", 0) >= 1
    assert c.get("decode.compile_miss") in (None, 0)   # fast path warmed


# ------------------------------------------------------------ fp8 KV pools
def test_fp8_quantize_roundtrip_row_stable():
    from mxnet_tpu_torch.serving.decode import (kv_dequantize_fp8,
                                                kv_quantize_rows_fp8)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 7, 2, 16).astype("float32"))
    q, scale = kv_quantize_rows_fp8(x)
    assert q.dtype == torch.float8_e4m3fn and scale.shape == (4, 7)
    xr = np.asarray(kv_dequantize_fp8(q, scale))
    xn = np.asarray(x)
    # e4m3 keeps 3 mantissa bits: relative error <= 2^-4 in the normal
    # range, absolute error bounded by the row scale in the subnormals
    err = np.abs(xr - xn)
    bound = np.abs(xn) / 16.0 + np.asarray(scale)[..., None, None] * 2e-3
    assert (err <= bound + 1e-7).all(), float((err - bound).max())
    # row stability: a row's codes don't depend on its neighbors
    q2, s2 = kv_quantize_rows_fp8(x[1:3])
    assert torch.equal(q2.view(torch.uint8), q[1:3].view(torch.uint8))
    assert (np.asarray(s2) == np.asarray(scale[1:3])).all()
    # all-zero rows (trash page) dequantize to exactly 0.0
    qz, sz = kv_quantize_rows_fp8(torch.zeros((1, 2, 16)))
    assert (np.asarray(kv_dequantize_fp8(qz, sz)) == 0.0).all()


def test_fp8_pool_geometry_between_fp32_and_int8():
    """fp8 stores 1-byte values with ONE f32 sidecar row per pool
    (absmax scale — no midpoint), vs int8's two (scale + mid): fp8
    pages are strictly cheaper than int8 pages and far cheaper than
    fp32."""
    def mk(kvd):
        return PagedKVCache(2, 2, 16, page_size=8, num_pages=4,
                            max_pages_per_seq=2, max_slots=2,
                            kv_dtype=kvd)
    fp32, fp8, i8 = mk(None), mk("fp8_e4m3"), mk("int8")
    assert fp8.kv_bytes_per_token < fp32.kv_bytes_per_token
    assert fp8.num_sidecars == 2 and i8.num_sidecars == 4
    assert fp8.kv_bytes_per_token < i8.kv_bytes_per_token
    assert fp8.page_bytes < i8.page_bytes
    # the pools really are fp8
    k_pool = fp8.pools[0]
    assert k_pool.dtype == torch.float8_e4m3fn


@pytest.fixture(scope="module")
def fp8_session():
    net = _net()
    sess = DecodeSession(net, batch_buckets=(1, 2), seq_buckets=(8, 16),
                         page_size=8, kv_dtype="fp8_e4m3")
    yield sess
    sess.close(drain=False)


def test_fp8_session_deterministic_and_shared(fp8_session):
    sess = fp8_session
    assert sess.cache.quantized and sess.stats()["kv_dtype"] == "fp8_e4m3"
    p = _prompt(3, 6, 12)
    r1 = sess.generate(p, max_new_tokens=5, temperature=0.8, seed=4,
                       timeout=120)
    r2 = sess.generate(p, max_new_tokens=5, temperature=0.8, seed=4,
                       timeout=120)
    # fp8 quantization is elementwise-deterministic: the shared-vs-cold
    # bitwise contract holds exactly like fp32/int8 (r2 rode the index)
    assert r1.token_ids == r2.token_ids
    assert sess.stats()["prefix_hits"] >= 1
    assert sess.cache.pages_in_use == 0


# ---------------------------------------------------- speculative decoding
from mxnet_tpu_torch.serving.decode import (  # noqa: E402
    Drafter, ModelDrafter, NgramDrafter, SpecState)


@pytest.fixture(scope="module")
def spec_runtime():
    """One warmed speculative runtime (verify ladder k=3) shared by the
    whole speculative block — its own net so reference schedulers built
    on it are exactly comparable."""
    net = _net()
    rt = DecodeRuntime(net, batch_buckets=(1, 2, 4), seq_buckets=(8, 16),
                       page_size=8, spec_buckets=(3,))
    yield rt


def _rep_prompt(i, n=9):
    """Motif-cycling prompt — the workload prompt-lookup drafting eats."""
    rng = np.random.RandomState(2000 + i)
    motif = list(rng.randint(1, VOCAB, 3))
    return (motif * ((n // 3) + 1))[:n]


def _spec_reqs(n=10):
    return [dict(prompt=_rep_prompt(i), max_new_tokens=4 + i % 5,
                 temperature=0.7 * (i % 3 == 0), seed=500 + i)
            for i in range(n)]


def _reference(spec_runtime, reqs):
    """Non-speculative streams from a drafterless scheduler on the SAME
    runtime (plain step programs, same weights)."""
    s = DecodeScheduler(spec_runtime)
    try:
        return [s.generate(timeout=120, **r).token_ids for r in reqs]
    finally:
        s.close(drain=False, timeout=10.0)


def test_spec_state_adapts_from_own_window():
    st = SpecState(2, 4)
    for _ in range(3):
        st.observe(2, 2)
    assert st.k == 2                      # needs >= 4 observations
    st.observe(2, 2)
    assert st.k == 3                      # hot window grows
    st.observe(3, 3)
    assert st.k == 4 and st.acceptance_rate == 1.0
    st.observe(4, 4)
    assert st.k == 4                      # capped at k_max
    cold = SpecState(3, 4)
    for _ in range(6):
        cold.observe(3, 0)
    assert cold.k == 1                    # shrinks, floors at 1
    cold.observe(0, 0)                    # zero-proposal rounds ignored
    assert cold.k == 1


def test_ngram_drafter_proposes_cycle_continuation():
    class R:
        prompt = np.array([5, 9, 2, 5, 9, 2, 5], "int32")
        tokens = []
    d = NgramDrafter()
    got = d.propose(R(), 3)
    assert got.tolist() == [9, 2, 5]      # continuation of latest [5]->...
    # longest suffix wins: trailing [2, 5] matches at position 2
    class R2:
        prompt = np.array([1, 2, 3, 4], "int32")
        tokens = []
    assert d.propose(R2(), 3).size == 0   # no repeat: no draft


def test_spec_continuous_and_solo_bitwise_with_zero_misses(spec_runtime):
    """THE tentpole contract: speculative streams — greedy and sampled,
    solo and continuous-batched — are bitwise the non-speculative streams,
    with zero steady-state compile misses and zero leaks."""
    reqs = _spec_reqs()
    ref = _reference(spec_runtime, reqs)
    spec_runtime.cache.drop_prefix_cache()
    s = DecodeScheduler(spec_runtime, drafter=NgramDrafter(), spec_k=3)
    try:
        solo = [s.generate(timeout=120, **r).token_ids for r in reqs]
        assert solo == ref
        spec_runtime.cache.drop_prefix_cache()
        telemetry.enable()
        telemetry.reset()
        futs = []
        for i, r in enumerate(reqs):
            futs.append(s.submit(**r))
            time.sleep(0.002 * (i % 4))
        cont = [f.result(120).token_ids for f in futs]
        snap = telemetry.snapshot()["counters"]
        telemetry.disable()
    finally:
        s.close(drain=False, timeout=10.0)
    assert cont == ref
    assert not snap.get("decode.compile_miss"), snap
    assert snap.get("decode.spec_steps", 0) >= 1
    assert snap.get("decode.spec_accepted", 0) >= 1   # drafting worked
    assert spec_runtime.cache.pages_in_use == 0
    assert spec_runtime.cache.slots_in_use == 0


def test_spec_mixed_batch_with_non_spec_rows(spec_runtime):
    """Speculating and opted-out requests share the same boundary: the
    opted-out rows ride the verify with n_draft=0 (bitwise the plain
    step) and every stream still matches the non-spec reference."""
    reqs = _spec_reqs(8)
    ref = _reference(spec_runtime, reqs)
    spec_runtime.cache.drop_prefix_cache()
    s = DecodeScheduler(spec_runtime, drafter=NgramDrafter(), spec_k=3)
    try:
        futs = [s.submit(speculate=(i % 2 == 0), **r)
                for i, r in enumerate(reqs)]
        got = [f.result(120).token_ids for f in futs]
    finally:
        s.close(drain=False, timeout=10.0)
    assert got == ref


class _ScriptedDrafter(Drafter):
    """Drafts from a scripted continuation table (prompt tuple -> the
    known reference stream), optionally corrupted — the deterministic
    way to pin acceptance behavior."""

    name = "scripted"

    def __init__(self, table, corrupt=False, overshoot=False):
        self.table = table
        self.corrupt = corrupt
        self.overshoot = overshoot

    def propose(self, req, k):
        ref = self.table[tuple(int(t) for t in req.prompt)]
        done = len(req.tokens)
        if self.overshoot:
            k = k + 7          # deliberately ignore the budget cap
        cont = np.asarray(ref[done:done + k], "int32")
        if self.corrupt and cont.size:
            cont = (cont + 1) % VOCAB       # never equals the target
        return cont


def _table(reqs, ref):
    return {tuple(r["prompt"]): t for r, t in zip(reqs, ref)}


def test_spec_oracle_drafts_commit_bonus_tokens(spec_runtime):
    """All-accepted rounds commit k+1 tokens (the bonus) and finish in
    far fewer verify steps than tokens; rejected-at-position-0 rounds
    still emit exactly the target's token. Both streams stay bitwise."""
    reqs = _spec_reqs(4)
    ref = _reference(spec_runtime, reqs)
    spec_runtime.cache.drop_prefix_cache()
    telemetry.enable()
    for drafter, expect_accepts in (
            (_ScriptedDrafter(_table(reqs, ref)), True),
            (_ScriptedDrafter(_table(reqs, ref), corrupt=True), False)):
        telemetry.reset()
        s = DecodeScheduler(spec_runtime, drafter=drafter, spec_k=3)
        try:
            got = [s.generate(timeout=120, **r).token_ids for r in reqs]
        finally:
            s.close(drain=False, timeout=10.0)
        assert got == ref
        snap = telemetry.snapshot()["counters"]
        if expect_accepts:
            assert snap.get("decode.spec_bonus", 0) >= 1
            assert snap["decode.spec_accepted"] > 0
        else:
            # acceptance at position 0: every draft token mismatches,
            # every verify commits exactly one target token
            assert snap.get("decode.spec_accepted", 0) == 0
            assert snap.get("decode.spec_bonus", 0) == 0
        spec_runtime.cache.drop_prefix_cache()
    telemetry.disable()


def test_spec_draft_overshoot_is_budget_capped(spec_runtime):
    """A drafter ignoring its k (longer than the remaining budget) is
    truncated by the scheduler: writes stay inside the page
    reservation, the stream is exact, nothing leaks."""
    reqs = [dict(prompt=_rep_prompt(i), max_new_tokens=3,
                 temperature=0.0, seed=900 + i) for i in range(3)]
    ref = _reference(spec_runtime, reqs)
    spec_runtime.cache.drop_prefix_cache()
    s = DecodeScheduler(
        spec_runtime,
        drafter=_ScriptedDrafter(_table(reqs, ref), overshoot=True),
        spec_k=3)
    try:
        got = [s.generate(timeout=120, **r).token_ids for r in reqs]
    finally:
        s.close(drain=False, timeout=10.0)
    assert got == ref
    assert all(len(t) == 3 for t in got)
    assert spec_runtime.cache.pages_in_use == 0


def test_spec_k0_budget_falls_back_to_plain_step(spec_runtime):
    """max_new_tokens=2 leaves zero draft budget after the first token
    (k <= max_new - generated - 1 = 0): the scheduler must run the
    plain step, not a degenerate verify."""
    reqs = [dict(prompt=_rep_prompt(i), max_new_tokens=2,
                 temperature=0.0, seed=950 + i) for i in range(3)]
    ref = _reference(spec_runtime, reqs)
    spec_runtime.cache.drop_prefix_cache()
    telemetry.enable()
    telemetry.reset()
    s = DecodeScheduler(spec_runtime, drafter=NgramDrafter(), spec_k=3)
    try:
        got = [s.generate(timeout=120, **r).token_ids for r in reqs]
    finally:
        s.close(drain=False, timeout=10.0)
    snap = telemetry.snapshot()["counters"]
    telemetry.disable()
    assert got == ref
    assert snap.get("decode.spec_steps", 0) == 0      # plain steps only
    assert snap.get("decode.steps", 0) >= 1


def test_spec_prefix_hit_session_speculates(spec_runtime):
    """A full-prompt prefix hit (admission IS the first token) must
    still enter speculative mode for its decode steps — and stay
    bitwise with the cold non-spec stream for the same (prompt, seed)."""
    p = _rep_prompt(7)
    kw = dict(max_new_tokens=6, temperature=0.8, seed=777)
    ref = _reference(spec_runtime, [dict(prompt=p, **kw)])[0]
    spec_runtime.cache.drop_prefix_cache()
    telemetry.enable()
    telemetry.reset()
    s = DecodeScheduler(spec_runtime, drafter=NgramDrafter(), spec_k=3)
    try:
        first = s.generate(p, timeout=120, **kw).token_ids   # publishes
        hit = s.generate(p, timeout=120, **kw).token_ids     # prefix hit
    finally:
        s.close(drain=False, timeout=10.0)
    snap = telemetry.snapshot()["counters"]
    telemetry.disable()
    assert first == ref and hit == ref
    assert snap.get("decode.prefix_hits", 0) >= 1
    assert snap.get("decode.spec_steps", 0) >= 1


def test_spec_drafter_failure_degrades_not_fails(spec_runtime):
    """Any drafter exception degrades the affected boundary/request to
    plain decode — requests never fail because a draft misfired."""
    class Exploding(Drafter):
        def __init__(self):
            self.calls = 0

        def propose_batch(self, reqs, ks):
            self.calls += 1
            raise RuntimeError("draft boom")

    reqs = _spec_reqs(3)
    ref = _reference(spec_runtime, reqs)
    spec_runtime.cache.drop_prefix_cache()
    d = Exploding()
    s = DecodeScheduler(spec_runtime, drafter=d, spec_k=3)
    try:
        got = [s.generate(timeout=120, **r).token_ids for r in reqs]
    finally:
        s.close(drain=False, timeout=10.0)
    assert got == ref and d.calls >= 1
    assert spec_runtime.cache.pages_in_use == 0


def test_model_drafter_self_draft_high_acceptance(spec_runtime):
    """ModelDrafter with the TARGET net as its own draft model: greedy
    requests accept every draft (the drafter computes exactly the
    target's argmax), so verify rounds commit bonus tokens — and its
    private KV cache frees every slot on detach."""
    reqs = [dict(prompt=_rep_prompt(i), max_new_tokens=7,
                 temperature=0.0, seed=600 + i) for i in range(4)]
    ref = _reference(spec_runtime, reqs)
    spec_runtime.cache.drop_prefix_cache()
    telemetry.enable()
    telemetry.reset()
    d = ModelDrafter(spec_runtime.block)
    s = DecodeScheduler(spec_runtime, drafter=d, spec_k=3)
    try:
        got = [s.generate(timeout=300, **r).token_ids for r in reqs]
    finally:
        s.close(drain=False, timeout=10.0)
    snap = telemetry.snapshot()["counters"]
    telemetry.disable()
    assert got == ref
    assert snap.get("decode.spec_bonus", 0) >= 1
    acc = snap.get("decode.spec_accepted", 0)
    prop = snap.get("decode.spec_proposed", 0)
    assert prop > 0 and acc / prop > 0.8          # greedy self-draft
    assert d.runtime.cache.stats()["pages_in_use"] == 0
    assert d.runtime.cache.stats()["slots_in_use"] == 0
    assert spec_runtime.cache.pages_in_use == 0


def test_spec_validation_errors(spec_runtime, runtime):
    with pytest.raises(ValueError, match="spec_buckets"):
        DecodeScheduler(runtime, drafter=NgramDrafter(), start=False)
    with pytest.raises(ValueError, match="spec_k"):
        DecodeScheduler(spec_runtime, drafter=NgramDrafter(), spec_k=9,
                        start=False)
    s = DecodeScheduler(spec_runtime)          # no drafter
    try:
        with pytest.raises(ValueError, match="no drafter"):
            s.submit(_rep_prompt(0), speculate=True)
    finally:
        s.close(drain=False, timeout=10.0)
    with pytest.raises(ValueError, match="unknown drafter"):
        DecodeScheduler(spec_runtime, drafter="nope", start=False)


# ----------------------------------- failure drills without the fault sites
class _FailingOnce:
    """Wraps a bound method: the first ``n`` calls raise, the rest pass
    through (the port's stand-in for ``MXNET_FAULTS=<site>:fail``)."""

    def __init__(self, fn, n=1, exc=RuntimeError("injected")):
        self.fn, self.left, self.exc = fn, n, exc

    def __call__(self, *args, **kwargs):
        if self.left > 0:
            self.left -= 1
            raise self.exc
        return self.fn(*args, **kwargs)


def test_step_failure_fails_batch_and_recovers(runtime, monkeypatch):
    s = DecodeScheduler(runtime, breaker_threshold=None)
    try:
        monkeypatch.setattr(runtime, "step", _FailingOnce(runtime.step))
        f = s.submit([1, 2, 3], max_new_tokens=4, seed=0)
        with pytest.raises(RuntimeError, match="injected"):
            f.result(60)
        assert runtime.cache.pages_in_use == 0             # slot freed
        ok = s.generate([1, 2, 3], max_new_tokens=4, seed=0, timeout=60)
        assert len(ok.token_ids) == 4                      # worker survived
        assert s.steps_failed == 1
    finally:
        monkeypatch.undo()
        s.close(drain=False, timeout=10.0)


def test_alloc_failure_sheds_request_only(runtime, monkeypatch):
    s = DecodeScheduler(runtime)
    try:
        monkeypatch.setattr(runtime.cache, "alloc",
                            _FailingOnce(runtime.cache.alloc))
        f = s.submit([1, 2], max_new_tokens=3, seed=0)
        with pytest.raises(RuntimeError, match="injected"):
            f.result(60)
        ok = s.generate([1, 2], max_new_tokens=3, seed=0, timeout=60)
        assert len(ok.token_ids) == 3
    finally:
        monkeypatch.undo()
        s.close(drain=False, timeout=10.0)


def test_circuit_breaker_opens_and_probes(runtime, monkeypatch):
    s = DecodeScheduler(runtime, breaker_threshold=1,
                        breaker_cooldown_ms=150.0)
    try:
        monkeypatch.setattr(runtime, "step", _FailingOnce(runtime.step))
        f = s.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="injected"):
            f.result(60)
        assert not s.healthy
        with pytest.raises(RequestRejected) as ei:
            s.submit([1], max_new_tokens=2)
        assert ei.value.reason == "unhealthy"
        time.sleep(0.2)                                    # cooldown expires
        assert s.healthy
        assert len(s.generate([1, 2, 3], max_new_tokens=3,
                              timeout=60).token_ids) == 3
    finally:
        monkeypatch.undo()
        s.close(drain=False, timeout=10.0)


def test_generations_under_sharing():
    """Freeing one holder of a shared prefix leaves its pages' generations
    alone; the last holder's release recycles them (the stamps the JAX
    package's slots sanitizer reads; the fence itself is ROADMAP item
    10); a double free raises."""
    c, prompt, a = _published_cache()
    b = c.alloc(3, prompt=prompt)
    shared = b.pages[:2]
    gens = [c.page_generation(p) for p in shared]
    slot_gen = c.generation(a.slot_id)
    c.free(a)
    assert c.generation(a.slot_id) == slot_gen + 1
    assert [c.page_generation(p) for p in shared] == gens
    with pytest.raises(ValueError):
        c.free(a)
    c.drop_prefix_cache()
    assert [c.page_generation(p) for p in shared] == gens   # b holds them
    c.free(b)
    assert [c.page_generation(p) for p in shared] == [g + 1 for g in gens]
    assert b.page_gens[:2] == gens                        # b's stale stamps


def test_unported_options_raise_and_placement():
    with pytest.raises(NotImplementedError, match="item 9"):
        PagedKVCache(2, 2, 16, mesh=object())
    net = _net()
    with pytest.raises(NotImplementedError, match="item 8"):
        DecodeRuntime(net, aot_cache="/nonexistent", warm=False)
    rt = DecodeRuntime(net, batch_buckets=(1,), seq_buckets=(8,),
                       page_size=8, warm=False)
    assert rt.device.type == "cpu" and rt.cache.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in rt.cache.pools)


def test_streamed_tokens_equal_buffered(runtime):
    s = DecodeScheduler(runtime)
    try:
        kw = dict(max_new_tokens=6, temperature=0.8, seed=12)
        buffered = s.generate(_prompt(5), timeout=60, **kw).token_ids
        stream = s.stream(_prompt(5), **kw)
        streamed = [stream.next_token(timeout=60) for _ in range(6)]
        with pytest.raises(StopIteration):
            stream.next_token(timeout=60)
        assert streamed == buffered == stream.result(60).token_ids
    finally:
        s.close(drain=False, timeout=10.0)
