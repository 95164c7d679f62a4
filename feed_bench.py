#!/usr/bin/env python3
"""Time the data path's feeds into ResNet-50 v1 training on one GPU.

    python3 feed_bench.py [--cv2-threads default,1] [--rounds 2]
                          [--feeds serial,prefetch,processes,augment,stage]

Writes ``chip_smoke.py``'s phase-26 corpus (768 JPEGs at 288x384, quality
85, in an indexed ``.rec`` under a temporary directory), seeds ResNet-50 v1
(1000 classes) as phase 6 does, and times phase 9's synthetic step (one
fixed batch of 32 on the card, 3 warm and 10 timed steps) as the ceiling.
Then, for each OpenCV thread setting in turn (``cv2.setNumThreads`` in this
process before the iterator is made; ``default`` is the count OpenCV
started with; the settings run A B .. B A over ``--rounds``), it feeds the
net from ``mx.io.ImageRecordIter`` in ``train_imagenet.py``'s configuration
(batch 32, SGD momentum 0.9, wd 1e-4, fp32 NCHW, TF32 off) in each way of
``--feeds``:

- ``serial``: the thread path (4 decode threads), ``as_in_context``;
- ``prefetch``: the thread path through ``DevicePrefetchIter`` (depth 2);
- ``processes``: 4 decode processes through ``DevicePrefetchIter``;
- ``augment``: 4 decode processes with ``device_augment``;
- ``stage``: the thread path through ``DevicePrefetchIter``, no step.

Each feed runs one warm and one timed epoch of 24 batches.  A line per
feed gives images/s, the loop's host milliseconds a batch split into the
wait for the batch and the step's own call (kernel launches, before any
sync), and the timed epoch's ``io.*`` counters.  Every line names the card
and its power limit.  Needs one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def _feeds(mx, gpu):
    def serial(it):
        for b in it:
            yield b.data[0].as_in_context(gpu), b.label[0].as_in_context(gpu)

    def prefetched(it):
        for b in mx.io.DevicePrefetchIter(it, depth=2):
            yield b.data[0], b.label[0]

    def augmented(it):
        aug = it.augmenter
        for b in mx.io.DevicePrefetchIter(it, depth=2):
            yield aug(b.data[0], b.augment_flip, b.augment_crop), b.label[0]

    procs = dict(preprocess_processes=cs.DP_PROCS,
                 pipeline_timeout=cs.DP_TIMEOUT)
    return {"serial": ({}, serial, True),
            "prefetch": ({}, prefetched, True),
            "processes": (procs, prefetched, True),
            "augment": (dict(procs, device_augment=True), augmented, True),
            "stage": ({}, prefetched, False)}


def _epoch(batches, step, train):
    """One epoch: (batches, seconds, host ms waiting for batches, host ms
    in the step calls, losses)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wait = call = 0.0
    losses = []
    it = iter(batches)
    while True:
        t1 = time.perf_counter()
        try:
            x, y = next(it)
        except StopIteration:
            break
        t2 = time.perf_counter()
        out = step(x, y) if train else x._data.sum() * 0
        t3 = time.perf_counter()
        wait += t2 - t1
        call += t3 - t2
        losses.append(out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return len(losses), secs, wait * 1e3, call * 1e3, \
        [float(l.mean()) for l in losses] if train else []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cv2-threads", default="default,1")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--feeds", default="serial,prefetch,processes,augment,"
                                       "stage")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("feed_bench: no CUDA device visible", file=sys.stderr)
        return 1
    import cv2

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, telemetry
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    card = cs.phase_environment()
    cs.phase_build()
    started = cv2.getNumThreads()
    settings = [started if s == "default" else int(s)
                for s in args.cv2_threads.split(",")]
    order = []
    for r in range(args.rounds):
        order += settings if r % 2 == 0 else settings[::-1]
    cs.log(f"[feed] os.cpu_count() {cs.os.cpu_count()}, torch threads "
           f"{torch.get_num_threads()}, OpenCV threads at start {started}; "
           f"settings in order {order}")

    gpu = mx.gpu(0)
    tmp = tempfile.mkdtemp(prefix="feed_bench_")
    cpu_net = get_model("resnet50_v1", classes=1000, device="cpu")
    with torch.inference_mode():
        cpu_net(torch.zeros(1, 3, 32, 32))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, t in sorted(cpu_net._collect_params_with_prefix()
                              .items()):
            t.copy_(torch.from_numpy(cs._seeded(name, tuple(t.shape), rng)
                                     .astype("float32")))
    cpu_net.save_parameters(f"{tmp}/resnet50_v1.params")
    del cpu_net
    net = get_model("resnet50_v1", classes=1000)
    net.load_parameters(f"{tmp}/resnet50_v1.params")
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            dict(cs.TRAIN_OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(x, y):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(cs.TRAIN_BATCH)
        return loss._data.detach()

    x = mx.nd.array(np.random.RandomState(1).randn(
        cs.TRAIN_BATCH, *cs.IMAGE).astype("float32"), ctx=gpu)
    y = mx.nd.array(np.arange(cs.TRAIN_BATCH) % 1000, ctx=gpu)
    for _ in range(cs.WARM_STEPS):
        step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cs.TIMED_STEPS):
        step(x, y)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / cs.TIMED_STEPS
    t0 = time.perf_counter()
    for _ in range(cs.TIMED_STEPS):
        step(x, y)
    call_ms = (time.perf_counter() - t0) * 1e3 / cs.TIMED_STEPS
    torch.cuda.synchronize()
    cs.log(f"[feed] synthetic step {step_ms:.3f} ms = "
           f"{cs.TRAIN_BATCH * 1e3 / step_ms:.1f} images/s; its call "
           f"{call_ms:.3f} ms of host time a step (launches, no sync); on "
           f"{card}")

    feeds = _feeds(mx, gpu)
    names = args.feeds.split(",")
    rates = {}
    try:
        rec = cs.write_corpus(tmp, cs.DP_IMAGES, cs.DP_HW)
        for threads in order:
            cv2.setNumThreads(threads)
            for name in names:
                extra, feed, train = feeds[name]
                it = mx.io.ImageRecordIter(path_imgrec=rec, seed=26,
                                           **dict(cs.DP_ITER, **extra))
                try:
                    _epoch(feed(it), step, train)
                    it.reset()
                    telemetry.enable()
                    telemetry.reset()
                    n, secs, wait, call, losses = _epoch(feed(it), step,
                                                         train)
                    snap = telemetry.snapshot()
                    telemetry.disable()
                finally:
                    it.close()
                cs.check(n == cs.DP_IMAGES // cs.TRAIN_BATCH and all(
                    math.isfinite(v) for v in losses),
                    f"[feed] {name}: {n} batches, losses {losses}")
                rate = n * cs.TRAIN_BATCH / secs
                rates.setdefault(f"{name} cv2={threads}", []).append(rate)
                cs.log(f"[feed] {name}, OpenCV threads {threads} "
                       f"(decoder {it.decoder}): {rate:.1f} images/s, "
                       f"{secs * 1e3 / n:.2f} ms a batch, of it host "
                       f"{wait / n:.2f} ms waiting for the batch and "
                       f"{call / n:.2f} ms in the step's call; io: "
                       f"{json.dumps(cs._io_reading(snap))}; on {card}")
    finally:
        telemetry.disable()
        shutil.rmtree(tmp, ignore_errors=True)
    cs.log("[feed] images/s: " + json.dumps(rates))
    return 0


if __name__ == "__main__":
    sys.exit(main())
