"""Continuous-batching decode scheduler + the ``generate()`` front-end.

Static batching runs a gang of requests start-to-finish: the batch drains
as its slowest member finishes and new arrivals wait for the whole gang.
**Continuous batching** admits requests into the *running* decode batch at
step boundaries and evicts finished sequences immediately, freeing their
KV pages for the next arrival — the device never idles while work is
queued, which is where the tokens/sec win at mixed prompt lengths comes
from.

The request plane carries over the ``Batcher``'s contract wholesale —
bounded queue with backpressure, per-request deadlines with load shedding,
circuit breaker after consecutive batch failures — plus one new shed
condition: **KV-cache exhaustion**.  A request whose page reservation can
*never* fit is rejected immediately (``reason="kv_exhausted"``); one that
merely can't fit *right now* waits for evictions (its deadline still
applies).  Admission reserves the full ``prompt + max_new_tokens`` page
budget, so an admitted sequence can always run to completion — mid-flight
eviction-for-space never happens.

Determinism: a request's token stream is a pure function of (prompt, seed,
temperature) — per-request PRNG keys fold the *request-local* token index,
and the runtime's row-stable math keeps every step bitwise-independent of
batch composition — so the same request returns bitwise-identical tokens
solo or inside any continuous batch (tested, and the property that makes
"replay this request" a debugging tool).

The port (``mxnet_tpu/serving/decode/scheduler.py``'s counterpart) keeps
the request plane, the counters of ``decode.*`` on the port's telemetry
bus and the token contract.  The worker thread runs on the runtime's
device (``torch.cuda.set_device``) on the default stream and copies the
chosen tokens to the host once a step.  The JAX scheduler's hooks into
fault injection (``decode.step``, ``decode.kv_alloc``), the slots
sanitizer, the flight recorder, the HTTP readiness registry and request
trace contexts are ROADMAP queue 1 item 10 and not ported.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future, InvalidStateError

import numpy as np

import torch

from ...telemetry import bus as _tel
from ..batcher import RequestRejected
from .kv_cache import KVCacheExhausted, pages_needed
from .runtime import DecodeRuntime
from .speculate import SpecState, resolve_drafter

__all__ = ["DecodeScheduler", "DecodeSession", "GenerationResult",
           "TokenStream"]

_NO_DRAFT = np.zeros((0,), "int32")


class TokenStream:
    """Incremental per-request token feed — the streaming (SSE) view of
    one generation.  Iterating yields token ids the moment the producing
    step boundary commits them; iteration ends when the request finishes
    (the :class:`GenerationResult` is then available via :meth:`result`)
    and re-raises the request's error if it was rejected, failed, or
    cancelled.

    The stream is an *observer*, not a fork: a request submitted with a
    sink appends to the very same token list and resolves the very same
    Future as a buffered one, and the per-request PRNG fold-in never sees
    the sink — so the streamed and buffered token sequences are
    bitwise-identical by construction (tested)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._pending = deque()
        self._done = False
        self._result = None
        self._exc = None
        self._future = None       # attached by stream()/submit's caller
        self._abort = None        # scheduler abort hook for running requests

    # ------------------------------- producer (scheduler worker thread)
    def _put(self, token):
        with self._cond:
            self._pending.append(int(token))
            self._cond.notify_all()

    def _finish(self, result):
        with self._cond:
            if not self._done:
                self._result = result
                self._done = True
                self._cond.notify_all()

    def _fail(self, exc):
        with self._cond:
            if not self._done:
                self._exc = exc
                self._done = True
                self._cond.notify_all()

    # ---------------------------------------------------------- consumer
    def next_token(self, timeout=None):
        """Block for the next token id.  Raises ``StopIteration`` at end
        of stream, the request's error on failure, ``TimeoutError`` when
        nothing arrives in time."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._cond:
            while True:
                if self._pending:
                    return self._pending.popleft()
                if self._done:
                    if self._exc is not None:
                        raise self._exc
                    raise StopIteration
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"no token within {timeout:.3f}s")
                self._cond.wait(timeout=remaining)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_token()

    def result(self, timeout=None):
        """The finished request's :class:`GenerationResult` (blocks until
        the request completes; tokens stay iterable — result() drains
        nothing)."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._cond:
            while not self._done:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("request still running")
                self._cond.wait(timeout=remaining)
            if self._exc is not None:
                raise self._exc
            return self._result

    @property
    def done(self):
        with self._cond:
            return self._done

    def cancel(self):
        """Best-effort cancel of the underlying request.  While queued
        the Future cancels outright; once running, the scheduler aborts
        the request at the next step boundary — the slot is evicted with
        ``reason="aborted"`` and every KV page freed (the
        client-hung-up-mid-stream path: decoding to completion for a
        departed reader would burn batch rows for nobody)."""
        cancelled = self._future.cancel() \
            if self._future is not None else False
        if not cancelled and self._abort is not None and not self.done:
            self._abort()
            return True
        return cancelled


class GenerationResult:
    """One finished request: generated ``token_ids`` (prompt excluded),
    ``finish_reason`` (``"eos"`` / ``"length"``), time-to-first-token and
    end-to-end latency in ms."""

    __slots__ = ("token_ids", "finish_reason", "ttft_ms", "latency_ms",
                 "prompt_len")

    def __init__(self, token_ids, finish_reason, ttft_ms, latency_ms,
                 prompt_len):
        self.token_ids = list(token_ids)
        self.finish_reason = finish_reason
        self.ttft_ms = ttft_ms
        self.latency_ms = latency_ms
        self.prompt_len = prompt_len

    def __repr__(self):
        return (f"GenerationResult({len(self.token_ids)} tokens, "
                f"{self.finish_reason!r}, ttft={self.ttft_ms:.1f}ms)")


class _Request:
    __slots__ = ("prompt", "max_new", "temp", "key", "eos_id", "deadline",
                 "future", "t_submit", "n_pages", "slot", "tokens",
                 "position", "step_idx", "cur", "ttft_ms",
                 "sink", "aborted", "spec", "spec_state")

    def __init__(self, prompt, max_new, temp, key, eos_id, deadline,
                 t_submit, n_pages):
        self.prompt = prompt
        self.max_new = max_new
        self.temp = temp
        self.key = key                    # (2,) uint32 request base key
        self.eos_id = eos_id
        self.deadline = deadline
        self.future = Future()
        self.t_submit = t_submit
        self.n_pages = n_pages
        self.slot = None                  # KVSlot once admitted
        self.tokens = []                  # generated ids
        self.position = len(prompt)       # next write position
        self.step_idx = 0                 # per-request sampling step
        self.cur = 0                      # last sampled token (step input)
        self.ttft_ms = None
        # sink: TokenStream observing this request (None for buffered
        # submits) — fed at exactly the points tokens land in `tokens`
        self.sink = None
        # aborted: client hung up / cancelled a RUNNING request; swept
        # out of the batch (slot freed) at the next step boundary
        self.aborted = False
        # spec: this request rides the speculative verify path (degrades
        # to False if the drafter fails to attach); spec_state carries
        # the adaptive per-request spec_k + acceptance window
        self.spec = False
        self.spec_state = None


class DecodeScheduler:
    """Worker thread running the continuous decode loop for one
    :class:`DecodeRuntime` (see module docstring for the contract).

    Parameters
    ----------
    runtime : DecodeRuntime
    queue_depth : int
        Bound on *queued* (not yet admitted) requests; beyond it
        ``submit()`` blocks (backpressure) or sheds on deadline expiry.
    start : bool
        Start the worker now (default); ``start=False`` lets tests
        enqueue deterministically.
    breaker_threshold / breaker_cooldown_ms
        Circuit breaker on consecutive prefill/step failures (None
        disables) — same semantics as ``serving.Batcher``.
    drafter : Drafter | "ngram" | CausalLM | None
        Enables speculative decoding: requests ride the fused verify
        program with this drafter's proposals (the runtime must have
        been built with ``spec_buckets``).  Output streams stay bitwise
        identical to non-speculative decode — acceptance is
        deterministic-equality against the target's own fold_in sample
        stream, so the drafter only ever changes tokens *per step*.
    spec_k : int | None
        Initial per-request draft length (adapts within
        ``[1, runtime.max_spec_k]`` from each request's windowed
        acceptance rate); default: the runtime's largest spec bucket.
    """

    def __init__(self, runtime, queue_depth=256, start=True,
                 breaker_threshold=8, breaker_cooldown_ms=1000.0,
                 drafter=None, spec_k=None):
        if not isinstance(runtime, DecodeRuntime):
            raise TypeError(f"need a DecodeRuntime, got {type(runtime)}")
        self._runtime = runtime
        self._cache = runtime.cache
        self._drafter = resolve_drafter(drafter)
        if self._drafter is not None and not runtime.spec_buckets:
            raise ValueError(
                "speculative decoding needs a runtime built with "
                "spec_buckets (the verify-program ladder); got none")
        self._spec_k0 = runtime.max_spec_k if spec_k is None \
            else int(spec_k)
        if self._drafter is not None and not \
                (1 <= self._spec_k0 <= runtime.max_spec_k):
            raise ValueError(
                f"spec_k must be in [1, {runtime.max_spec_k}], "
                f"got {self._spec_k0}")
        if self._drafter is not None:
            self._drafter.bind(runtime)
        if int(queue_depth) < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.queue_depth = int(queue_depth)
        self._queue = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._drain = True
        self._started = False
        self._worker = None
        self._active = []                 # worker-thread-owned
        self.steps_failed = 0
        self.worker_restarts = 0
        if breaker_threshold is not None and int(breaker_threshold) < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1 or None, "
                f"got {breaker_threshold}")
        self._breaker_threshold = None if breaker_threshold is None \
            else int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown_ms) / 1e3
        self._consecutive_failures = 0
        self._breaker_open_until = 0.0
        if start:
            self.start()

    # --------------------------------------------------------------- client
    def submit(self, prompt, max_new_tokens=16, temperature=0.0, seed=0,
               eos_id=None, deadline_ms=None, sink=None, speculate=None):
        """Enqueue one generation request; returns a Future resolving to a
        :class:`GenerationResult`.

        ``speculate`` opts one request in/out of the speculative verify
        path (default: speculate iff the scheduler has a drafter).  The
        token stream is bitwise-identical either way — speculation only
        changes how many tokens each step commits.

        Malformed requests (empty prompt, out-of-range ids, a prompt +
        budget that overflows the context window) raise synchronously.  A
        reservation larger than the whole KV cache is shed immediately
        with ``reason="kv_exhausted"`` — it could never be admitted.

        ``sink`` (a :class:`TokenStream`) observes the request
        incrementally: each token is pushed at the step boundary that
        produced it, and the sink terminates with the same result or
        error the Future resolves with.  The sink changes NOTHING about
        scheduling or sampling — the buffered token stream stays
        bitwise-identical."""
        t_submit = time.perf_counter()
        rt = self._runtime
        prompt = np.asarray(prompt, "int32").reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size > rt.max_prompt_len:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds the largest seq "
                f"bucket ({rt.max_prompt_len})")
        vocab = rt.block.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt ids outside [0, {vocab})")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        ctx = self._cache.context_length
        if prompt.size + max_new > ctx:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds the context window ({ctx})")
        n_pages = pages_needed(prompt.size, max_new, self._cache.page_size)
        # request base key: any deterministic uint32 pair works (the step
        # program folds the per-request token index into it); derived in
        # numpy so submit() never touches the device
        seed = int(seed) & 0xffffffffffffffff
        key = np.array([seed >> 32, seed & 0xffffffff], "uint32")
        deadline = (t_submit + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        if speculate and self._drafter is None:
            raise ValueError(
                "speculate=True but the scheduler has no drafter")
        req = _Request(prompt, max_new, float(temperature), key,
                       eos_id, deadline, t_submit, n_pages)
        req.spec = (self._drafter is not None if speculate is None
                    else bool(speculate))
        if req.spec:
            req.spec_state = SpecState(self._spec_k0,
                                       self._runtime.max_spec_k)
        req.sink = sink
        if sink is not None:
            # the sink's cancel() reaches back here once the request is
            # RUNNING (Future.cancel no longer can): flag it for the
            # worker's boundary sweep
            sink._abort = lambda: self._abort_request(req)
        with self._lock:
            if self._closed:
                self._reject(req, "shutdown", "scheduler is closed")
                raise req.future.exception()
            if self._breaker_open_until and \
                    time.perf_counter() < self._breaker_open_until:
                self._reject(
                    req, "unhealthy",
                    f"circuit breaker open after "
                    f"{self._consecutive_failures} consecutive failures")
                raise req.future.exception()
            if not self._cache.fits_ever(n_pages):
                self._reject(
                    req, "kv_exhausted",
                    f"reservation of {n_pages} pages can never fit "
                    f"({self._cache.usable_pages} usable, "
                    f"{self._cache.reclaimable_pages()} reclaimable from "
                    f"the shared-prefix cache)")
                raise req.future.exception()
            if self._started:
                self._respawn_worker_locked()
            while len(self._queue) >= self.queue_depth:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    self._reject(req, "deadline",
                                 "queue stayed full past the deadline")
                    raise req.future.exception()
                self._not_full.wait(timeout=remaining)
                if self._closed:
                    self._reject(req, "shutdown", "scheduler is closed")
                    raise req.future.exception()
            self._queue.append(req)
            if _tel.enabled:
                _tel.count("decode.requests", model=self._runtime.name)
                _tel.gauge("decode.queue_depth", len(self._queue),
                           model=self._runtime.name)
            self._not_empty.notify()
        return req.future

    def generate(self, prompt, timeout=None, **kwargs):
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(prompt, **kwargs).result(timeout)

    def stream(self, prompt, **kwargs):
        """Submit and return a :class:`TokenStream` yielding token ids as
        each step boundary commits them — the SSE data source.  Raises
        synchronously exactly like :meth:`submit` (malformed request,
        breaker open, impossible reservation)."""
        sink = TokenStream()
        future = self.submit(prompt, sink=sink, **kwargs)
        sink._future = future
        return sink

    def pending(self):
        with self._lock:
            return len(self._queue)

    def _abort_request(self, req):
        """Mark a running request for eviction at the next boundary (the
        worker owns the batch; this thread only raises the flag)."""
        with self._lock:
            req.aborted = True
            self._not_empty.notify()

    def active(self):
        """Sequences currently in the decode batch (approximate — read
        without joining the step boundary)."""
        return len(self._active)

    @property
    def healthy(self):
        if self._closed:
            return False
        if self._breaker_open_until and \
                time.perf_counter() < self._breaker_open_until:
            return False
        return True

    @property
    def breaker_remaining_s(self):
        """Seconds until an open circuit breaker lets traffic probe
        again (0.0 when closed) — the honest ``Retry-After`` value for
        ``reason="unhealthy"`` sheds."""
        return max(0.0, self._breaker_open_until - time.perf_counter())

    def _reject(self, req, reason, detail):
        if _tel.enabled:
            _tel.count("decode.rejections", model=self._runtime.name,
                       reason=reason)
            _tel.instant("decode.rejection", model=self._runtime.name,
                         reason=reason)
        exc = RequestRejected(reason, detail)
        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            pass       # client cancel() won the race; nobody is waiting
        if req.sink is not None:
            req.sink._fail(exc)

    # --------------------------------------------------------------- worker
    def start(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._started = True
            self._respawn_worker_locked()

    def _respawn_worker_locked(self):
        if self._worker is None or not self._worker.is_alive():
            if self._worker is not None:
                self.worker_restarts += 1
                if _tel.enabled:
                    _tel.count("decode.worker_restart",
                               model=self._runtime.name)
            self._worker = threading.Thread(
                target=self._run, daemon=True,
                name=f"decode-scheduler-{self._runtime.name}")
            self._worker.start()

    def _run(self):
        if self._runtime.device.type == "cuda":
            # the current device is per thread: the worker's kernels and
            # allocations go to the runtime's card
            torch.cuda.set_device(self._runtime.device)
        while True:
            with self._lock:
                while not self._queue and not self._active:
                    if self._closed:
                        return
                    self._not_empty.wait()
                if self._closed and not self._drain:
                    self._abort_locked()
                    break
            self._boundary()
            with self._lock:
                if self._closed and not self._active and \
                        (not self._drain or not self._queue):
                    self._shed_queue_locked("shutdown")
                    break
        with self._lock:
            self._not_full.notify_all()

    def _boundary(self):
        """One step boundary — admit under the lock, then prefill the
        joins and step the batch outside it.  The ONE body both the live
        worker and ``close()``'s inline settle run, so the two paths can
        never diverge."""
        self._sweep_aborted()
        with self._lock:
            joining = self._admit_locked()
            self._not_full.notify_all()
            if _tel.enabled:
                _tel.gauge("decode.queue_depth", len(self._queue),
                           model=self._runtime.name)
        try:
            if joining:
                self._prefill(joining)
            if self._active:
                self._step()
        except BaseException as e:
            self._fail_active(e, joining)

    def _sweep_aborted(self):
        """Evict requests whose client gave up (stream cancel / hung-up
        SSE reader) before spending another step on them.  Runs on the
        worker thread at the boundary, before admission — the freed
        pages are allocatable in the same boundary."""
        if not any(req.aborted for req in self._active):
            return
        still = []
        for req in self._active:
            if not req.aborted:
                still.append(req)
                continue
            self._evict(req, "aborted")
            exc = CancelledError()
            if not req.future.done():
                req.future.set_exception(exc)
            if req.sink is not None:
                req.sink._fail(exc)
        self._active = still

    def _abort_locked(self):
        """Non-drain shutdown: shed the queue, fail the active batch,
        free every slot."""
        self._shed_queue_locked("shutdown")
        for req in self._active:
            self._evict(req, "shutdown")
            exc = RequestRejected("shutdown", "scheduler closed")
            if not req.future.done():
                req.future.set_exception(exc)
            if req.sink is not None:
                req.sink._fail(exc)
        self._active = []

    def _shed_queue_locked(self, reason):
        while self._queue:
            self._reject(self._queue.popleft(), reason,
                         "scheduler closed without drain")

    def _admit_locked(self):
        """Move queued requests into the batch at this step boundary:
        shed expired deadlines, then admit in arrival order while a KV
        reservation and a batch-bucket row are available.  Called under
        the lock; cache alloc/free only ever happens on this worker
        thread."""
        # deadline shedding sweeps the whole queue: a request behind a
        # too-big head must not rot past its deadline unobserved
        alive = deque()
        now = time.perf_counter()
        for req in self._queue:
            if req.future.cancelled():
                # never entered the batch, held no slot: not an eviction
                # — the request simply vanishes (its stream, if any,
                # still has to terminate)
                if req.sink is not None:
                    req.sink._fail(CancelledError())
            elif req.deadline is not None and now > req.deadline:
                self._reject(req, "deadline",
                             "expired waiting for admission")
            else:
                alive.append(req)
        self._queue = alive
        joining = []
        was_running = bool(self._active)
        while self._queue and \
                len(self._active) + len(joining) < self._runtime.max_batch:
            req = self._queue[0]
            try:
                # the prompt rides along: matched published prefix pages
                # are acquired by refcount (and a full-prompt hit carries
                # cached first-token logits) instead of allocated cold
                req.slot = self._cache.alloc(req.n_pages,
                                             prompt=req.prompt)
            except KVCacheExhausted:
                break        # wait for evictions; deadline still applies
            except Exception as e:
                # injected decode.kv_alloc fault (or a real allocator
                # error): fail THIS request, keep the scheduler alive
                self._queue.popleft()
                self._evict(req, "failed")
                try:
                    req.future.set_exception(e)
                except InvalidStateError:
                    pass      # client cancel() won the race
                if req.sink is not None:
                    req.sink._fail(e)
                continue
            self._queue.popleft()
            # claim the future BEFORE it enters the batch: once RUNNING, a
            # client cancel() can no longer race _finish's set_result (the
            # Batcher discipline); a cancel that won the race releases the
            # just-reserved slot here
            if not req.future.set_running_or_notify_cancel():
                self._evict(req, "cancelled")
                if req.sink is not None:
                    req.sink._fail(CancelledError())
                continue
            joining.append(req)
        if joining and _tel.enabled and was_running:
            _tel.count("decode.joins", len(joining),
                       model=self._runtime.name)
        return joining

    # ------------------------------------------------------------ decode ops
    def _prefill(self, joining):
        """Prefill admitted requests grouped by seq bucket, each group
        padded to a (batch, seq) grid point.  Requests whose whole prompt
        matched a published prefix never enter a group: their K/V is
        already paged in and the cached logits yield the first token —
        the prefix-hit TTFT path."""
        rt = self._runtime
        groups = {}
        for req in joining:
            if req.spec:
                # a failing drafter degrades the request to plain decode
                # (bitwise the same stream, just one token per step) —
                # drafts are never worth failing a request over
                try:
                    self._drafter.attach(req)
                except Exception as e:
                    req.spec = False
                    if _tel.enabled:
                        _tel.count("decode.spec_degraded", model=rt.name)
                        _tel.instant("decode.spec_degraded", model=rt.name,
                                     error=repr(e))
        for req in joining:
            if req.slot.prefix_logits is not None:
                self._admit_prefix_hit(req)
            else:
                groups.setdefault(rt.seq_bucket_for(req.prompt.size),
                                  []).append(req)
        for s, reqs in sorted(groups.items()):
            for i in range(0, len(reqs), rt.max_batch):
                self._prefill_group(reqs[i:i + rt.max_batch], s)

    def _admit_prefix_hit(self, req):
        """A full-prompt prefix hit: admission IS the time-to-first-token
        — one batch-1 sample over the cached last-position logits (row-
        stable, so the token is bitwise what a cold prefill would have
        sampled), no prefill program, no K/V recompute."""
        rt = self._runtime
        first = rt.sample_first(req.slot.prefix_logits, req.key, req.temp)
        req.slot.prefix_logits = None
        now = time.perf_counter()
        req.ttft_ms = (now - req.t_submit) * 1e3
        if _tel.enabled:
            _tel.count("decode.ttft_ms", round(req.ttft_ms, 3),
                       model=rt.name)
            _tel.record_span("decode.ttft", req.t_submit, now, model=rt.name)
            _tel.observe("decode.ttft_ms", req.ttft_ms)
            _tel.count("decode.tokens", 1, model=rt.name)
            _tel.count("decode.prefill_skips", model=rt.name)
        req.cur = first
        req.tokens.append(first)
        if req.sink is not None:
            req.sink._put(first)
        req.step_idx = 1
        if self._is_finished(req):
            self._finish(req)
        else:
            self._active.append(req)
        self._consecutive_failures = 0

    def _prefill_group(self, reqs, s):
        rt, cache = self._runtime, self._cache
        b = rt.batch_bucket_for(len(reqs))
        tokens = np.zeros((b, s), "int32")
        lengths = np.ones((b,), "int32")
        tables = np.zeros((b, cache.max_pages_per_seq), "int32")
        keys = np.zeros((b, 2), "uint32")
        temps = np.zeros((b,), "float32")
        for r, req in enumerate(reqs):
            tokens[r, :req.prompt.size] = req.prompt
            lengths[r] = req.prompt.size
            # write_table: a partial prefix hit re-runs the full dense
            # prefill (bitwise the cold computation) but masks its shared
            # pages to the trash page at commit — their content is
            # already paged in and possibly read by live sequences
            tables[r] = req.slot.write_table()
            keys[r] = req.key
            temps[r] = req.temp
        first, logits = rt.prefill(tokens, lengths, tables, keys, temps)
        if logits is not None:
            # publish BEFORE any decode step: each slot's prompt pages
            # hold exactly the prompt K/V right now (generated tokens
            # land later), so the index copies/pins clean pages
            for r, req in enumerate(reqs):
                cache.publish(req.slot, req.prompt, logits[r])
        now = time.perf_counter()
        done = []
        for r, req in enumerate(reqs):
            req.ttft_ms = (now - req.t_submit) * 1e3
            if _tel.enabled:
                _tel.count("decode.ttft_ms", round(req.ttft_ms, 3),
                           model=rt.name)
                _tel.record_span("decode.ttft", req.t_submit, now,
                                 model=rt.name)
                _tel.observe("decode.ttft_ms", req.ttft_ms)
            req.cur = int(first[r])
            req.tokens.append(req.cur)
            if req.sink is not None:
                req.sink._put(req.cur)
            req.step_idx = 1
            if self._is_finished(req):
                done.append(req)
            else:
                self._active.append(req)
        if _tel.enabled:
            _tel.count("decode.tokens", len(reqs), model=rt.name)
            _tel.count("decode.prefills", len(reqs), model=rt.name)
        for req in done:
            self._finish(req)
        self._consecutive_failures = 0

    def _step(self):
        """One decode step over the active batch, padded to a batch
        bucket.

        With a drafter bound, boundaries where at least one active row
        produced a draft ride the fused verify program instead
        (:meth:`_spec_step`) — non-speculating rows ride along with
        ``n_draft = 0``, which is bitwise the plain step for them."""
        rt, cache = self._runtime, self._cache
        drafts = self._collect_drafts()
        if drafts is not None:
            self._spec_step(drafts)
            return
        if cache.prefix_sharing:
            # copy-on-write fence: the page each row is about to write
            # must be exclusively owned.  Admission already privatized
            # every write-path page (shared pages only ever cover the
            # prompt), so this is two refcount reads per row — but it is
            # the guard that makes "a shared page is never scribbled on"
            # an invariant instead of an accident.
            for req in self._active:
                cache.ensure_writable(req.slot,
                                      req.position // cache.page_size)
        n = len(self._active)
        b = rt.batch_bucket_for(n)
        tokens = np.zeros((b,), "int32")
        positions = np.zeros((b,), "int32")
        tables = np.zeros((b, cache.max_pages_per_seq), "int32")
        keys = np.zeros((b, 2), "uint32")
        steps = np.zeros((b,), "int32")
        temps = np.zeros((b,), "float32")
        for r, req in enumerate(self._active):
            tokens[r] = req.cur
            positions[r] = req.position
            tables[r] = req.slot.page_table
            keys[r] = req.key
            steps[r] = req.step_idx
            temps[r] = req.temp
        t0 = time.perf_counter()
        nxt = rt.step(tokens, positions, tables, keys, steps, temps)
        t1 = time.perf_counter()
        if _tel.enabled:
            _tel.count("decode.steps", model=rt.name)
            _tel.count("decode.tokens", n, model=rt.name)
            _tel.observe("decode.step_ms", (t1 - t0) * 1e3)
        still = []
        for r, req in enumerate(self._active):
            req.cur = int(nxt[r])
            req.tokens.append(req.cur)
            if req.sink is not None:
                req.sink._put(req.cur)
            req.position += 1
            req.step_idx += 1
            if self._is_finished(req):
                self._finish(req)
            else:
                still.append(req)
        self._active = still
        self._consecutive_failures = 0

    def _collect_drafts(self):
        """Per-row draft proposals for this boundary, or ``None`` when
        nobody speculates (no drafter, every row opted out / budget-
        capped to zero, the drafter errored, or every draft came back
        empty) — the caller then runs the plain step program."""
        if self._drafter is None:
            return None
        ks = []
        for req in self._active:
            k = 0
            if req.spec:
                # budget cap: the verify commits at most k+1 tokens, so
                # k never exceeds the remaining budget minus one — the
                # last written position stays inside the page
                # reservation (prompt + max_new - 2)
                k = min(req.spec_state.k,
                        req.max_new - len(req.tokens) - 1)
            ks.append(max(k, 0))
        if not any(ks):
            return None
        try:
            proposed = self._drafter.propose_batch(self._active, ks)
        except Exception as e:
            if _tel.enabled:
                _tel.count("decode.spec_draft_failures",
                           model=self._runtime.name)
                _tel.instant("decode.spec_draft_failure",
                             model=self._runtime.name, error=repr(e))
            return None
        vocab = self._runtime.block.vocab_size
        drafts, any_draft = [], False
        for d, k in zip(proposed, ks):
            d = np.asarray(d, "int32").reshape(-1)[:k]
            if d.size and (d.min() < 0 or d.max() >= vocab):
                d = _NO_DRAFT      # drafter bug: ids outside the vocab
            drafts.append(d)
            any_draft = any_draft or d.size > 0
        return drafts if any_draft else None

    def _spec_step(self, drafts):
        """One fused draft-verify step: write candidate K/V, score all
        drafted positions against the target's own deterministic sample
        stream, commit the accepted prefix plus the target's token at
        the first mismatch (or the bonus token when everything matched).
        Rolled-back K/V needs no cleanup — positions past the new
        ``req.position`` stay causally masked until a later boundary
        overwrites them."""
        rt, cache = self._runtime, self._cache
        n = len(self._active)
        kb = rt.spec_bucket_for(max(d.size for d in drafts))
        b = rt.batch_bucket_for(n)
        tokens = np.zeros((b, kb + 1), "int32")
        positions = np.zeros((b,), "int32")
        n_draft = np.zeros((b,), "int32")
        tables = np.zeros((b, cache.max_pages_per_seq), "int32")
        keys = np.zeros((b, 2), "uint32")
        steps = np.zeros((b,), "int32")
        temps = np.zeros((b,), "float32")
        for r, (req, d) in enumerate(zip(self._active, drafts)):
            tokens[r, 0] = req.cur
            if d.size:
                tokens[r, 1:1 + d.size] = d
            positions[r] = req.position
            n_draft[r] = d.size
            tables[r] = req.slot.page_table
            keys[r] = req.key
            steps[r] = req.step_idx
            temps[r] = req.temp
            if cache.prefix_sharing:
                # the verify writes positions [position, position + k]:
                # privatize EVERY page that span touches, not just the
                # current one (a draft can cross a page boundary)
                first = req.position // cache.page_size
                last = (req.position + int(d.size)) // cache.page_size
                for idx in range(first, last + 1):
                    cache.ensure_writable(req.slot, idx)

        t0 = time.perf_counter()
        target, n_acc = rt.verify(tokens, positions, n_draft, tables,
                                  keys, steps, temps)
        t1 = time.perf_counter()
        committed = 0
        still = []
        for r, (req, d) in enumerate(zip(self._active, drafts)):
            m = int(n_acc[r])
            finished = False
            for t in target[r, :m + 1]:
                req.cur = int(t)
                req.tokens.append(req.cur)
                if req.sink is not None:
                    req.sink._put(req.cur)
                req.position += 1
                req.step_idx += 1
                committed += 1
                if self._is_finished(req):
                    finished = True
                    break          # eos mid-commit: drop the tail
            if d.size:
                req.spec_state.observe(int(d.size), m)
                if _tel.enabled:
                    _tel.count("decode.spec_proposed", int(d.size),
                               model=rt.name)
                    _tel.count("decode.spec_accepted", m, model=rt.name)
                    if m == d.size:
                        _tel.count("decode.spec_bonus", model=rt.name)
                    _tel.observe("decode.spec_accept_rate",
                                 m / int(d.size))
            if finished:
                self._finish(req)
            else:
                if d.size:
                    try:
                        self._drafter.observe(req, int(d.size), m)
                    except Exception:
                        req.spec = False
                still.append(req)
        if _tel.enabled:
            _tel.count("decode.steps", model=rt.name)
            _tel.count("decode.spec_steps", model=rt.name)
            _tel.count("decode.tokens", committed, model=rt.name)
            _tel.observe("decode.step_ms", (t1 - t0) * 1e3)
            _tel.observe("decode.spec_tokens_per_step", committed / n)
        self._active = still
        self._consecutive_failures = 0

    @staticmethod
    def _is_finished(req):
        if req.eos_id is not None and req.cur == req.eos_id:
            return True
        return len(req.tokens) >= req.max_new

    def _finish(self, req):
        reason = "eos" if (req.eos_id is not None
                           and req.cur == req.eos_id) else "length"
        self._evict(req, reason)
        latency = (time.perf_counter() - req.t_submit) * 1e3
        res = GenerationResult(req.tokens, reason, req.ttft_ms, latency,
                               req.prompt.size)
        req.future.set_result(res)
        if req.sink is not None:
            req.sink._finish(res)

    def _evict(self, req, reason):
        """Free a sequence's KV slot the moment it leaves the batch —
        continuous batching's whole point is that the next arrival can
        take these pages at the very next boundary."""
        if req.spec and self._drafter is not None:
            try:
                self._drafter.detach(req)
            except Exception:
                pass          # a leaky drafter must not block eviction
        if req.slot is not None:
            self._cache.free(req.slot)
            req.slot = None
        if _tel.enabled:
            _tel.count("decode.evictions", model=self._runtime.name,
                       reason=reason)

    def _fail_active(self, exc, joining=()):
        """A prefill/step crash fails the requests that were in flight —
        their slots are freed, the worker survives, the breaker advances
        (consecutive failures open it).  ``joining`` covers requests
        admitted this boundary whose prefill never completed (they are
        not in the active list yet)."""
        self.steps_failed += 1
        if _tel.enabled:
            _tel.count("decode.step_failures", model=self._runtime.name)
            _tel.instant("decode.step_failure", model=self._runtime.name,
                         error=repr(exc))
        in_active = set(map(id, self._active))
        for req in joining:
            if id(req) not in in_active and not req.future.done():
                self._evict(req, "failed")
                req.future.set_exception(exc)
                if req.sink is not None:
                    req.sink._fail(exc)
        for req in self._active:
            self._evict(req, "failed")
            if not req.future.done():
                req.future.set_exception(exc)
            if req.sink is not None:
                req.sink._fail(exc)
        self._active = []
        if self._breaker_threshold is None:
            return
        self._consecutive_failures += 1
        if self._consecutive_failures >= self._breaker_threshold:
            self._breaker_open_until = \
                time.perf_counter() + self._breaker_cooldown
            if _tel.enabled:
                _tel.count("decode.breaker_open", model=self._runtime.name)

    # ------------------------------------------------------------- shutdown
    def close(self, drain=True, timeout=60.0):
        """Stop the scheduler.  ``drain=True`` (default) finishes every
        queued and active request first; ``drain=False`` rejects the
        queue (``reason="shutdown"``) and fails active requests."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._drain = bool(drain)
            worker = self._worker
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if worker is not None and worker.is_alive():
            worker.join(timeout=timeout)
        if worker is not None and worker.is_alive():
            return      # hung worker: don't race it from this thread
        # no live worker (never started / crashed): settle inline
        if drain:
            while True:
                with self._lock:
                    if not self._queue and not self._active:
                        break
                self._boundary()
        else:
            with self._lock:
                self._abort_locked()

    def __del__(self):
        try:
            self.close(drain=False, timeout=1.0)
        except Exception:
            pass


class DecodeSession:
    """The one-stop ``generate()`` front-end: builds the
    :class:`~mxnet_tpu_torch.serving.decode.runtime.DecodeRuntime` (2-D prefill
    grid + step programs, warmed) and the continuous-batching
    :class:`DecodeScheduler` around an initialized
    :class:`~mxnet_tpu_torch.serving.decode.model.CausalLM` on its device::

        net = mx.serving.decode.get_decode_model("decode_small")
        net.initialize()
        sess = mx.serving.decode.DecodeSession(net, page_size=16)
        out = sess.generate([5, 9, 2], max_new_tokens=32, temperature=0.8,
                            seed=7)
        out.token_ids, out.finish_reason, out.ttft_ms
        sess.close()

    ``submit()`` returns a Future for concurrent clients; requests join
    the running decode batch at step boundaries."""

    def __init__(self, block, batch_buckets=(1, 2, 4, 8), seq_buckets=None,
                 page_size=16, num_pages=None, max_slots=None,
                 kv_dtype=None, prefix_sharing=True, mesh=None,
                 queue_depth=256, warm=True, start=True, aot_cache=None,
                 drafter=None, spec_k=4, spec_buckets=None,
                 **scheduler_kwargs):
        if spec_buckets is None:
            # a drafter implies speculative decoding: one verify bucket
            # wide enough for the requested spec_k (adaptive per-request
            # k stays within it)
            spec_buckets = (int(spec_k),) if drafter is not None else ()
        self.runtime = DecodeRuntime(
            block, batch_buckets=batch_buckets, seq_buckets=seq_buckets,
            page_size=page_size, num_pages=num_pages, max_slots=max_slots,
            kv_dtype=kv_dtype, prefix_sharing=prefix_sharing,
            mesh=mesh, warm=warm, aot_cache=aot_cache,
            spec_buckets=spec_buckets)
        self.cache = self.runtime.cache
        self.scheduler = DecodeScheduler(
            self.runtime, queue_depth=queue_depth, start=start,
            drafter=drafter,
            spec_k=(min(int(spec_k), self.runtime.max_spec_k)
                    if drafter is not None else None),
            **scheduler_kwargs)

    def submit(self, prompt, **kwargs):
        return self.scheduler.submit(prompt, **kwargs)

    def generate(self, prompt, timeout=None, **kwargs):
        return self.scheduler.generate(prompt, timeout=timeout, **kwargs)

    def stream(self, prompt, **kwargs):
        """Incremental generation: a :class:`TokenStream` yielding ids as
        step boundaries commit them (the SSE data source)."""
        return self.scheduler.stream(prompt, **kwargs)

    def tokens(self, prompt, **kwargs):
        """Iterate token ids incrementally — alias for :meth:`stream`
        (the stream IS an iterator)."""
        return self.scheduler.stream(prompt, **kwargs)

    @property
    def healthy(self):
        return self.scheduler.healthy

    @property
    def breaker_remaining_s(self):
        return self.scheduler.breaker_remaining_s

    def stats(self):
        s = self.cache.stats()
        s["pending"] = self.scheduler.pending()
        s["active"] = self.scheduler.active()
        return s

    def close(self, drain=True, timeout=60.0):
        self.scheduler.close(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=False)
        return False
