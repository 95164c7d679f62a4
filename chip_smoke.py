#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off for matmul and cuDNN so that every
   fp32 comparison below is a true fp32 comparison;
2. build: the kernel library from ``mxnet_tpu_torch/csrc/`` with ``nvcc``;
3. kernel vs plain: the flash-attention kernel against its plain PyTorch
   version on the card (fp32 atol 1e-4; bf16 atol 2e-2 against the plain
   version in fp32 on the same bf16 inputs, i.e. the output's rounding),
   at BERT's bucket (8, 12, 128, 64), its maximum length (8, 12, 512, 64)
   and ragged T and D, and its fp32 time at both shapes, causal off and
   on, beside the plain version, ``F.scaled_dot_product_attention`` (a
   yardstick the port never calls) and the card's bound, on the 3xTF32
   tensor-core rate and on the FMA rate;
4. slice: BERT-base (12 layers, 768 units, 12 heads, vocab 30522, seeded
   random weights) behind ``ModelRuntime`` (buckets 1, 2, 4, 8) and
   ``Batcher``, answering 16 requests of 128 tokens from 4 client threads.
   Every answer must match the same weights run on the CPU through the plain
   path in fp32 within atol 2e-3 (post-LN values are O(1); 12 layers and a
   different summation order separate the two), with zero compile misses,
   exactly 12 kernel launches per micro-batch, and no plain-attention call
   on a CUDA tensor;
5. rtc: ``mx.rtc`` compiles ``double_k`` (through ``compile_cuda``) and
   MXNet's ``axpy`` example (through ``CudaModule``) with NVRTC, runs them
   once as a user would (``double_k`` on (8, 128), ``axpy`` at 8x64x112x112,
   ResNet-50's largest activation), holds both bitwise against their plain
   torch expressions, and times ``axpy`` beside ``y + alpha * x``,
   ``y.add_(x, alpha=alpha)`` and its memory bound (``axpy``'s ``x`` is
   passed as an ``mx.nd`` NDArray, as MXNet's ``launch`` takes them);
6. resnet: ResNet-50 v1 (1000 classes, seeded random weights and BatchNorm
   statistics, carried onto the card through a ``.params`` file) behind
   ``ModelRuntime`` (buckets 1, 2, 4, 8) and ``Batcher``, answering 16
   requests of (3, 224, 224) fp32 from 4 client threads.  Every answer must
   match the same weights run on the CPU plain path within
   1e-3 * max|logit| (TF32 off), be finite with std > 0, with zero compile
   misses.  ResNet-50 runs no kernel of the port: cuDNN convolutions and
   BatchNorm and cuBLAS carry it through torch, as XLA carries it in the JAX
   package.

7. bn-stats kernel vs plain: the BatchNorm statistics kernel against its
   plain version with the training pivot on the nine BatchNorm input
   geometries of ResNet-50 at 224 and batch 32, fp32 and bf16, plus a
   ragged (3, 5, 7, 9) and a mean-1000 case (atol 2e-5 on a variance of
   0.25; 1e-4 at mean 1000, where fp32's own step is 6e-5), and per fp32
   geometry its time beside the plain version, ``torch.var_mean`` (a
   yardstick the port never calls) and the card's bound, and its fp16
   time beside fp16's bound.  Every case also runs with the kernel
   reading its own pivot (``bs.FIRST``, the main path's call; it must give
   the explicit pivot's bits, twice), the plan it launched is logged, the
   times are of that call; where the plan folds its slices in a
   thread-block cluster, the same launch folding through the tickets is
   timed beside it (the per-forward sums too); the wrapper's host
   microseconds a call of ``batch_stats`` (forward, and forward plus
   backward) are timed by ``perf_counter`` over 200 warm calls;
8. training parity: ResNet-50 v1 (phase 6's seeded weights and
   ``.params`` file) takes 2 SGD steps (lr 0.01, momentum 0.9, wd 1e-4,
   ``SoftmaxCrossEntropyLoss``) at batch 8 on the card and on the CPU
   plain path.  The per-step losses, every step-1 gradient and every
   parameter and running statistic after step 2 must agree within 1e-4 of
   each tensor's max, or twice the CPU run's own spread when the batch is
   reordered (the same training in exact arithmetic) if that is larger.
   Every training forward must launch the kernel exactly 53 times (one
   per BatchNorm) and the plain statistics must never see a CUDA tensor;
9. training: the same model at full width, batch 32 of (3, 224, 224): 3
   warm steps, then 10 timed steps (synchronised): step ms, images/s, peak
   device memory, finite losses, 53 launches per step.  This is the slice's
   main path: the kernel's ``launches`` in the JSON line count it.  One
   more step (as in phases 18 and 22) holds each of its 53 bn-stats
   launches against the plain version on the same input.  Its
   ``[profile]`` (as phases 18 and 22's) counts the ``bn_stats`` kernels
   of one step against its 53 calls (one launch a call; a step under the
   profiler's warm-up comes first, and where the trace holds another
   count it logs which launches have no kernel record) and prints the
   wrapper's (``_BatchStats``) host ms.

10. BERT pretraining parity: ``bert_base`` at full width (768 units, 12
   heads, vocab 30522) cut to 2 layers, seeded weights, masked LM + next
   sentence with MXNet's loop (``SoftmaxCrossEntropyLoss``, Adam at lr
   1e-4) on ``example/bert/pretrain.py``'s synthetic batch (batch 4, T 128,
   20 masked positions), 2 steps on the card and on the CPU plain path, on
   the flash route (no mask) and the dense one (a padded mask).  Losses,
   the gradients of both steps and parameters after step 2 must agree
   within 1e-4 of each tensor's max or twice the CPU run's own spread
   under a batch reordering, plus for parameters what Adam makes of the
   runs' gradient disagreement: its step is scale-free in the gradient, so
   a fraction R apart in the gradient is up to 2 R lr apart a step, 2 lr
   where the gradient is rounding noise (the key bias); the elements that
   need it are counted, at most 32 outside the key biases, all in tensors
   that start at zero;
11. BERT-base pretraining, the slice's main path: 12 layers at full width,
   batch 32, T 128, 20 masked positions, Adam lr 1e-4, fp32 with TF32 off,
   ``dropout=0.0`` (the flash route): 3 warm and 10 timed steps: step ms,
   sequences/s, tokens/s, peak device memory, finite losses that fall,
   12 kernel launches and 12 backward calls a step, no plain attention on
   the card; a ``[profile]`` of one step; then 5 steps of the dense route
   (an all-ones ``valid_mask``, the bench's input) for its step time.
12. ``mx.nd``: every op of the table (``mxnet_tpu_torch/test_utils.py``'s
   cases) on the card and on the CPU from the same seeded inputs, outputs
   and gradients at the CPU tests' tolerances (fp32 rtol 1e-5, atol 1e-6;
   fp16 and bf16 1e-2 relative; integer, index and shape outputs exact),
   every result on the card; the samplers by moments (100k draws, 5
   standard errors) and by stream (the same seed, the same bits); the ops
   not run are named (there must be none); then
   ``nd.contrib.flash_attention`` at (8, 12, 128, 64) fp32 (exactly one
   kernel launch, within 1e-4 of the plain version) and training
   ``nd.BatchNorm`` at (32, 64, 56, 56) fp32 (exactly one bn-stats launch,
   output and moving statistics within 1e-4 of the CPU plain path);
13. BERT-base pretraining through NDArrays: phase 11's configuration as
   ``example/bert/pretrain.py`` writes it (``mx.nd.array(..., ctx=
   mx.gpu(0))`` inputs, ``net.initialize(ctx=...)``, NDArray outputs,
   ``loss.backward()``, ``trainer.step``, ``loss.wait_to_read()``,
   ``loss.asscalar()``; no mask, so the flash route).  Its first 3 steps
   from phase 11's weights: losses, every step's gradients and the final
   parameters within the tensor path's difference from a second run of
   itself plus 1e-6 of each tensor's max (those three runs with torch's
   deterministic algorithms); then 3 warm and 10 timed steps
   (step ms, sequences/s, peak memory beside phase 11's) at 12 flash
   launches and 12 backward calls a step.

14. the symbolic path (``mx.sym``, the Executor, the local KVStore,
   ``Module``): ResNet-50 v1 at full width written with ``mx.sym`` calls
   (:func:`resnet_v1_symbol`), batch 8, numpy-seeded weights carried to
   the card and to the CPU with ``Module.set_params``; 2 SGD steps
   (``forward_backward`` + ``update``, kvstore ``'local'``, phase 8's
   optimizer) on each, held to phase 8's criterion (losses, step-1
   gradients, parameters and auxiliary states within 1e-4 of each
   tensor's max or twice the CPU run's own spread under a reordering of
   the batch); 53 bn-stats launches per forward and no plain statistics
   on the card; the graph's ``tojson``/``load_json`` round trip gives the
   same outputs on the card bit for bit;
15. ``Module.fit`` at full width, batch 32, over an ``NDArrayIter`` of 13
   seeded batches (``Xavier`` initialisation, SGD, ``eval_metric=["acc",
   "ce"]``, a ``Speedometer``, kvstore ``'local'``): the step ms of the
   10 steps after 3 warm ones, images/s and peak device memory beside
   phase 9's gluon step, 689 bn-stats launches (53 a step), and a
   ``[profile]`` of one step (idle share, top kernels, host ms of the
   Executor's walk, backward, the kvstore update and the metric).  This
   is the Module path's main run: the bn-stats record's
   ``module_launches`` counts it.

16. AMP BERT parity: phase 10's cut (2 layers at bert_base width, batch
   4, T 128, seeded weights) under ``amp.init()`` (bf16), 3 Adam steps
   with ``amp.init_trainer`` and ``amp.scale_loss``, on the card and on
   the CPU (three CPU runs: AMP, AMP with the batch reordered, fp32).  The
   dtype of every layer output on the card equals the CPU's; the losses,
   every step's unscaled gradients and the parameters after step 3 (past
   Adam's allowance, phase 10) are within twice the CPU AMP run's own
   noise, per tensor in L2 norm: the larger of its distance from itself
   with the batch reordered and from the fp32 run (bf16 rounding is
   discontinuous, so another summation order, the card's, draws that
   noise anew); the flash kernel runs on bf16 q, k, v, one launch and
   one backward call a layer a step;
17. AMP BERT-base pretraining: phase 11's configuration under
   ``amp.init()``, 3 warm and 10 timed steps: step ms, sequences/s and
   peak memory beside phase 11's fp32 step, a ``[profile]`` of one step
   (idle share, top kernels, the flash forward's and Adam's shares, the
   copy (cast) kernels' device ms), 156 flash launches, all on bf16;
18. AMP ResNet-50 v1 training: phase 8's parity under AMP (2 SGD steps at
   batch 8, card against three CPU runs, held as in phase 16, equal
   layer dtypes), then phase 9's batch-32 run under AMP, timed and
   profiled beside phase 9's; 53 bn-stats launches a forward, all on fp32
   inputs (BatchNorm is on AMP's fp32 list);
19. fp16 storage and the symbolic route: ResNet-50 v1 ``cast("float16")``
   (BatchNorm keeps fp32 parameters) with ``SGD(multi_precision=True,
   momentum=0.9)``, 2 steps at batch 8, card against CPU (held as in
   phase 16, the fp32 run being phase 8's), 53 bn-stats launches a
   forward on fp16 inputs, and ``mp_sgd_mom_update`` per parameter on
   the card equal bit for bit to the grouped update; then
   ``amp.convert_model`` of :func:`resnet_v1_symbol` through
   ``Module.forward``, inference at batch 8, card against CPU.

20. bn-stats channels-last vs plain: the kernel on channels-last data
   (its ``rows`` route with K = 1) at the nine NHWC BatchNorm geometries
   of ResNet-50 at batch 32, fp32 and fp16, against its plain version
   (atol 2e-5, as phase 7) and, in fp32, against the NCHW layout on the
   same data transposed (1e-6: the same pivot element, another summation
   order); per geometry its time beside the plain version,
   ``torch.var_mean`` over (0, 1, 2) and the bound, the own-pivot check
   and the wrapper's host time as phase 7;
21. NHWC parity: ResNet-50 v1 ``layout="NHWC"`` at full width and depth,
   phase 6's weights transposed to (O, kh, kw, I) into a ``.params``
   file: fp32 logits at batch 8 on the card against the CPU within 1e-4
   of their max, the NCHW net on the card with the original weights the
   same; then phase 8's parity in NHWC for 3 SGD steps, every launch on
   the channels-last entry and no BatchNorm input copied;
22. NHWC training: phase 9's run with the NHWC net, fp32 and under AMP,
   beside phases 9 and 18 of the same call; 53 channels-last launches a
   forward, 0 copies (a fail stops the run); a ``[profile]`` with the
   NCHW<->NHWC transposes, copies and convolutions by kind.  The fp32
   run is the channels-last entry's main path: its ``launches`` count it;
23. the rest of the training loop: each of slice 10's optimizers (and
   ``adamw_update``) on an MLP's parameters with seeded gradients, card
   against CPU within 1e-5 of each tensor's max (SGLD by its noise's
   moments), each grouped rule bit for bit its per-parameter update on
   the card, every new loss with its input gradient and a
   ``backward(create_graph=True)`` second derivative, card against CPU.

Phase 1 also prints what a JPEG data path would find: whether ``cv2``,
``PIL`` and ``torchvision`` import and ``g++ -ljpeg`` links (a report;
it never fails the run).

Phase 3 also holds and times the flash forward in bf16 at phase 11's
(32, 12, 128, 64), the AMP path's shape, beside SDPA in bf16 and the bound
on the bf16 tensor-core rate.

Phase 13 reads its peak without a manual ``gc.collect()``: a gluon
Parameter holds its block's tensor weakly, so the parity runs' models are
freed when they return, and the peak must not exceed phase 11's.

Phase 3b follows phase 3: the flash route's gradient (``dQ``, ``dK``,
``dV``, the port's dense ``_attention_backward``) against the gradient of
the plain version at (8, 12, 128, 64) and (8, 12, 512, 64), fp32 and bf16,
causal off and on, at phase 11's (32, 12, 128, 64) fp32, and ragged T and D
(fp32 within 1e-4 of each tensor's max; bf16 within that plus half a bf16
ulp of it, 2^-8, the gradient's one rounding), and at BERT's serving bucket
and phase 11's shape the times of the backward, of forward plus backward
and of SDPA's forward plus backward (a yardstick the port never calls),
beside the backward's bound.  Phase 3 holds and times the forward at phase
11's shape too.

Phases 4, 6, 9, 11, 17, 18 and 22 print a ``[profile]`` breakdown of one
micro-batch or step.  The last two lines are the kernels' JSON record and
the device line.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import logging
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEQ = 128
N_REQUESTS = 16
N_CLIENTS = 4
SLICE_QKV = (8, 12, SEQ, 64)           # bucket 8 of bert_base: (B, H, T, D)
LONG_QKV = (8, 12, 512, 64)            # the same at bert_base's max_length
IMAGE = (3, 224, 224)
AXPY_SHAPE = (8, 64, 112, 112)         # bucket 8 of ResNet-50's stem output
BUILD = Path(__file__).resolve().parent / "build" / "chip_smoke"
RESNET50_BN = [(32, 64, 112, 112), (32, 64, 56, 56), (32, 256, 56, 56),
               (32, 128, 28, 28), (32, 512, 28, 28), (32, 256, 14, 14),
               (32, 1024, 14, 14), (32, 512, 7, 7), (32, 2048, 7, 7)]
RESNET50_BN_NHWC = [(n, h, w, c) for n, c, h, w in RESNET50_BN]
NHWC_PARITY_STEPS = 3
TRAIN_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
PARITY_BATCH, PARITY_STEPS = 8, 2
TRAIN_BATCH, WARM_STEPS, TIMED_STEPS = 32, 3, 10
BN_PER_FORWARD = 53                    # BatchNorm layers of ResNet-50 v1
VOCAB, MASKED = 30522, 20              # bench.py:340-378, pretrain.py
PRETRAIN_LR = 1e-4
PT_PARITY_BATCH, PT_PARITY_LAYERS, PT_PARITY_STEPS = 4, 2, 2
# phase 10's elements outside the key biases that may rely on Adam's
# allowance, all in tensors initialised at zero (measured on an H100: 12 on
# the flash route, 20 on the dense one)
ALLOWANCE_CAP = 32
PT_BATCH, PT_LAYERS, PT_WARM, PT_TIMED, PT_DENSE = 32, 12, 3, 10, 5
TRAIN_QKV = (PT_BATCH, 12, SEQ, 64)    # what phase 11 gives the kernel
HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,    # fp32 outside the tensor cores
              torch.bfloat16: 989e12, torch.float16: 989e12}
# fp32-accurate products on the tensor cores: 3xTF32, three TF32 products
# (495 TFLOP/s) for each fp32 one
TENSOR_FLOPS = {torch.float32: 495e12 / 3,
                torch.bfloat16: 989e12, torch.float16: 989e12}


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def device_ms(fn, iters=50):
    """Device time per call.  The stream is held by a sleep kernel while
    the host enqueues all calls, so the calls run back to back and the
    events see device time, not the host's launch rate.  The sleep lasts
    at least twice the host's time to enqueue them (measured on warm-up
    calls; an autograd forward and backward takes ~1 ms of host time), at
    2 GHz, H100 SXM's top clock, and never under 50M cycles."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(50_000_000, int(2 * host_s * iters * 2e9)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype, causal=False, peak=None):
    """Least time for (B, H, T, D) attention: read q, k, v and write out
    once, and 4*B*H*T^2*D operations (half that when causal) at ``peak``
    FLOP/s, by default the tensor cores' rate for ``dtype``."""
    b, h, t, d = shape
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * h * t * d * elem
    ops = 4 * b * h * t * t * d * (0.5 if causal else 1.0)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / (peak or TENSOR_FLOPS[dtype]) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def bn_stats_bound_ms(shape, dtype, axis=1):
    """Least time for the statistics of a tensor over every axis but
    ``axis`` (1 in NCHW, 3 in NHWC): read it and the pivot once, write
    mean and var; 3 operations an element."""
    n = math.prod(shape)
    elem = torch.empty((), dtype=dtype).element_size()
    by_bytes = (n * elem + 3 * shape[axis] * 4) / HBM_BYTES_PER_S * 1e3
    by_ops = 3 * n / PEAK_FLOPS[torch.float32] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[environment] data path: {json.dumps(data_path_libraries())}")
    return card


def data_path_libraries():
    """What the machine offers a JPEG data path: whether ``cv2``, ``PIL``
    and ``torchvision`` import, and whether ``g++`` links a one-line
    program against ``-ljpeg`` (in a temporary directory).  Reports; never
    fails the run."""
    import tempfile
    found = {}
    for mod in ("cv2", "PIL", "torchvision"):
        try:
            importlib.import_module(mod)
            found[mod] = True
        except Exception as e:                  # noqa: BLE001 (a report)
            found[mod] = f"no ({type(e).__name__})"
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "j.c"
        src.write_text("#include <stdio.h>\n#include <jpeglib.h>\n"
                       "int main(void) { struct jpeg_decompress_struct c; "
                       "jpeg_create_decompress(&c); return 0; }\n")
        try:
            r = subprocess.run(["g++", "-x", "c++", str(src), "-o",
                                str(Path(d) / "j"), "-ljpeg"],
                               capture_output=True, text=True, timeout=60)
            found["g++ -ljpeg"] = True if r.returncode == 0 else \
                f"no ({(r.stderr.strip().splitlines() or ['?'])[-1][:120]})"
        except (OSError, subprocess.SubprocessError) as e:
            found["g++ -ljpeg"] = f"no ({type(e).__name__})"
    return found


def phase_build():
    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s)")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem")):
            log(f"[build] {line.strip()}")


def phase_kernel(fa, card):
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    cases = [(SLICE_QKV, torch.float32, False),
             (SLICE_QKV, torch.float32, True),
             (SLICE_QKV, torch.bfloat16, False),
             (SLICE_QKV, torch.bfloat16, True),
             (LONG_QKV, torch.float32, True),
             (TRAIN_QKV, torch.float32, False),
             ((2, 2, 200, 64), torch.float32, False),
             ((2, 2, 200, 64), torch.float32, True),
             ((2, 2, 256, 128), torch.float32, False),
             ((2, 2, 256, 128), torch.float32, True),
             ((1, 3, 77, 40), torch.float32, False)]
    errs = {}
    for shape, dtype, causal in cases:
        q, k, v = (torch.from_numpy(rng.randn(*shape).astype("float32"))
                   .to(dev, dtype) for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1])
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = fa._reference(q.float(), k.float(), v.float(), causal, scale)
        err = (out.float() - ref).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        log(f"[kernel] {tuple(shape)} {str(dtype)[6:]} causal={causal}: "
            f"max_abs_err {err:.3e} (tol {tol:g})")
        check(out.dtype == dtype and out.shape == q.shape,
              f"kernel output {out.dtype} {tuple(out.shape)}")
        check(math.isfinite(err) and err <= tol,
              f"kernel disagrees with plain version at {shape} {dtype} "
              f"causal={causal}: {err}")
        if dtype == torch.float32 and not causal:
            errs[shape] = err

    # q/k/v were just written by the QKV projection in the real caller, so
    # they are timed warm in L2 (12.6 MB of the 50 MB cache; 50 MB at T=512
    # and at the pretraining batch), not flushed
    timed = {}
    for shape in (SLICE_QKV, LONG_QKV, TRAIN_QKV):
        q, k, v = (torch.from_numpy(rng.randn(*shape).astype("float32"))
                   .to(dev) for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1])
        for causal in (False, True) if shape != TRAIN_QKV else (False,):
            r = {"ms": device_ms(lambda: fa.flash_attention(
                     q, k, v, causal=causal, scale=scale)),
                 "plain_ms": device_ms(lambda: fa._reference(
                     q, k, v, causal, scale)),
                 "library_ms": device_ms(
                     lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=causal, scale=scale))}
            r["bound_ms"], r["bound_by"] = attention_bound_ms(
                shape, torch.float32, causal)
            r["bound_fma_ms"] = attention_bound_ms(
                shape, torch.float32, causal,
                peak=PEAK_FLOPS[torch.float32])[0]
            timed[shape, causal] = r
            log(f"[kernel] {shape} fp32 causal={causal}: kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; 3xTF32 tensor-core rate), fp32 FMA "
                f"bound {r['bound_fma_ms']:.4f} ms; on {card}")
    # the AMP pretraining path's dtype and shape (phase 17): bf16 q/k/v
    q, k, v = (torch.from_numpy(rng.randn(*TRAIN_QKV).astype("float32"))
               .to(dev, torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(TRAIN_QKV[-1])
    out = fa.flash_attention(q, k, v, scale=scale)
    ref = fa._reference(q.float(), k.float(), v.float(), False, scale)
    bf16 = {"shape": list(TRAIN_QKV), "dtype": "bfloat16",
            "max_abs_err": (out.float() - ref).abs().max().item(),
            "ms": device_ms(lambda: fa.flash_attention(q, k, v,
                                                       scale=scale)),
            "plain_ms": device_ms(lambda: fa._reference(q, k, v, False,
                                                        scale)),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale))}
    check(out.dtype == torch.bfloat16 and bf16["max_abs_err"] <= 2e-2,
          f"bf16 kernel at {TRAIN_QKV} disagrees: {bf16['max_abs_err']}")
    bf16["bound_ms"], bf16["bound_by"] = attention_bound_ms(
        TRAIN_QKV, torch.bfloat16)
    log(f"[kernel] {TRAIN_QKV} bf16 causal=False: max_abs_err "
        f"{bf16['max_abs_err']:.3e} (tol 2e-2); kernel {bf16['ms']:.4f} ms, "
        f"plain {bf16['plain_ms']:.4f} ms, sdpa bf16 "
        f"{bf16['library_ms']:.4f} ms, bound {bf16['bound_ms']:.4f} ms "
        f"({bf16['bound_by']}; {4 * math.prod(TRAIN_QKV) * 2 / 1e6:.1f} MB "
        f"at {HBM_BYTES_PER_S / 1e12:g} TB/s, "
        f"{4 * math.prod(TRAIN_QKV) * TRAIN_QKV[2] / 1e9:.2f} GFLOP at the "
        f"bf16 dense tensor-core rate "
        f"{TENSOR_FLOPS[torch.bfloat16] / 1e12:g} TFLOP/s); on {card}")
    main = timed[SLICE_QKV, False]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:101",
            "shape": list(SLICE_QKV), "dtype": "float32",
            "max_abs_err": errs[SLICE_QKV], **main, "kernel_ms": main["ms"],
            "causal_ms": timed[SLICE_QKV, True]["ms"],
            "t512": {"shape": list(LONG_QKV), **timed[LONG_QKV, False],
                     "causal": timed[LONG_QKV, True]},
            "train": {"shape": list(TRAIN_QKV), "max_abs_err": errs[TRAIN_QKV],
                      **timed[TRAIN_QKV, False]},
            "train_bf16": bf16}


def flash_backward_bound_ms(shape, dtype):
    """Least time for the attention backward: read q, k, v and dO once,
    write dQ, dK and dV once, and 4 products of B*H*T^2*D multiply-adds
    (dV, dP, dQ, dK; the recompute of S would be a fifth) at the tensor
    cores' rate for ``dtype``."""
    b, h, t, d = shape
    elem = torch.empty((), dtype=dtype).element_size()
    by_bytes = 7 * b * h * t * d * elem / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * 2 * b * h * t * t * d / TENSOR_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def phase_flash_grad(fa, card):
    """The flash route's gradient against the plain version's on the card,
    and its times at BERT's serving bucket and at the pretraining batch;
    returns the fields the flash record gains."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    cases = [(SLICE_QKV, torch.float32, False),
             (SLICE_QKV, torch.float32, True),
             (SLICE_QKV, torch.bfloat16, False),
             (SLICE_QKV, torch.bfloat16, True),
             (LONG_QKV, torch.float32, False),
             (LONG_QKV, torch.float32, True),
             (LONG_QKV, torch.bfloat16, True),
             (TRAIN_QKV, torch.float32, False),
             ((2, 2, 200, 64), torch.float32, True),
             ((1, 3, 77, 40), torch.float32, False)]
    errs = {}
    for shape, dtype, causal in cases:
        q, k, v, g = (torch.from_numpy(rng.randn(*shape).astype("float32"))
                      .to(dev, dtype) for _ in range(4))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        launches = fa.flash_attention.launches
        calls = fa.flash_attention.backward_calls
        fa.flash_attention(*leaves, causal=causal).backward(g)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches == launches + 1 and
              fa.flash_attention.backward_calls == calls + 1,
              "the flash route's gradient did not run the kernel forward "
              "and the port's backward once each")
        plain = [x.float().requires_grad_() for x in (q, k, v)]
        fa._reference(*plain, causal, shape[-1] ** -0.5).backward(g.float())
        tol = 1e-4 + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0)
        err = 0.0
        for got, ref in zip(leaves, plain):
            check(got.grad is not None and got.grad.dtype == dtype,
                  f"no {dtype} gradient reached a leaf input")
            err = max(err, (got.grad.float() - ref.grad).abs().max().item()
                      / ref.grad.abs().max().item())
        log(f"[flash_grad] {tuple(shape)} {str(dtype)[6:]} causal={causal}: "
            f"dQ, dK, dV max_abs_err {err:.3e} of each tensor's max "
            f"(tol {tol:.3e})")
        check(math.isfinite(err) and err <= tol,
              f"flash gradient disagrees with the plain version's at "
              f"{shape} {dtype} causal={causal}: {err}")
        if dtype == torch.float32 and not causal:
            errs.setdefault(shape, err)

    timed = {shape: _time_flash_grad(fa, rng, shape, card)
             for shape in (SLICE_QKV, TRAIN_QKV)}
    r = timed[SLICE_QKV]
    r["backward_max_abs_err"] = errs[SLICE_QKV]
    r["train_backward"] = {"shape": list(TRAIN_QKV), **timed[TRAIN_QKV],
                           "backward_max_abs_err": errs[TRAIN_QKV]}
    return r


def _time_flash_grad(fa, rng, shape, card):
    """The flash route's backward and forward+backward at fp32 ``shape``,
    beside the plain route's and SDPA's, and the backward's bound."""
    dev = torch.device("cuda")
    q, k, v, g = (torch.from_numpy(rng.randn(*shape).astype("float32"))
                  .to(dev) for _ in range(4))
    scale = 1.0 / math.sqrt(shape[-1])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def fwd_bwd(attend):
        return lambda: torch.autograd.grad(attend(*leaves), leaves, g)

    sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    r = {"backward_ms": device_ms(lambda: fa._attention_backward(
             q, k, v, g, False, scale)),
         "fwd_bwd_ms": device_ms(fwd_bwd(
             lambda *a: fa.flash_attention(*a, scale=scale))),
         "plain_fwd_bwd_ms": device_ms(fwd_bwd(
             lambda *a: fa._reference(*a, False, scale))),
         "sdpa_fwd_bwd_ms": device_ms(fwd_bwd(
             lambda *a: F.scaled_dot_product_attention(*a, scale=scale))),
         "sdpa_backward_ms": device_ms(lambda: torch.autograd.grad(
             sdpa_out, leaves, g, retain_graph=True))}
    r["backward_bound_ms"], r["backward_bound_by"] = \
        flash_backward_bound_ms(shape, torch.float32)
    log(f"[flash_grad] {shape} fp32: backward (dense recompute, torch "
        f"matmuls) {r['backward_ms']:.4f} ms, bound "
        f"{r['backward_bound_ms']:.4f} ms ({r['backward_bound_by']}; 3xTF32 "
        f"tensor-core rate), SDPA backward {r['sdpa_backward_ms']:.4f} ms; "
        f"forward+backward: flash route {r['fwd_bwd_ms']:.4f} ms, plain "
        f"{r['plain_fwd_bwd_ms']:.4f} ms, SDPA {r['sdpa_fwd_bwd_ms']:.4f} "
        f"ms; on {card}")
    return r


def serve(batcher, payloads):
    """All requests from N_CLIENTS threads, each submitting its share at
    once; returns (answers, sorted latencies in ms, wall seconds)."""
    n = len(payloads)
    answers = [None] * n
    t_submit = [0.0] * n
    t_done = [0.0] * n
    per_client = n // N_CLIENTS

    def client(c):
        futs = []
        for i in range(c * per_client, (c + 1) * per_client):
            t_submit[i] = time.perf_counter()
            fut = batcher.submit(payloads[i])
            fut.add_done_callback(
                lambda f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append((i, fut))
        for i, fut in futs:
            answers[i] = fut.result(timeout=300)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(all(not t.is_alive() for t in threads), "a client thread hung")
    check(all(a is not None for a in answers), "a request got no answer")
    return answers, sorted((d - s) * 1e3 for s, d in zip(t_submit, t_done)), \
        wall


@contextlib.contextmanager
def kernel_dtypes(mod):
    """Records the input dtype of every CUDA launch of ``mod``'s kernel
    (the flash or the bn-stats module: their ``_check`` runs once before
    each launch and nowhere else)."""
    seen, real = [], mod._check

    def checked(x, *rest):
        seen.append(x.dtype)
        return real(x, *rest)

    mod._check = checked
    try:
        yield seen
    finally:
        mod._check = real


def _kernel_share(kernels, busy_ms):
    """Device ms of the kernel families that show whether AMP reached the
    products, by name: copies (the casts among them), NCHW<->NHWC
    transposes, tensor-core products in bf16/fp16 (cuBLAS's ``nvjet``
    kernels on Hopper, kernels named for bf16 or f16 operands) and fp32
    products on the FMA units (``ffma``, ``sgemm``, ``simt``)."""
    def ms(*words):
        return sum(e.self_device_time_total for e in kernels
                   if any(w in e.key.lower() for w in words)) / 1e3
    parts = [("copy kernels (casts among them)", ms("copy")),
             ("nchw<->nhwc transposes", ms("nchwtonhwc", "nhwctonchw")),
             ("bf16/fp16 tensor-core products", ms("nvjet", "bf16",
                                                  "f16f16")),
             ("fp32 FMA products", ms("ffma", "sgemm", "simt"))]
    return ", ".join(f"{n} {v:.3f} ms ({v / busy_ms:.3f})" for n, v in parts)


@contextlib.contextmanager
def no_plain_attention_on_cuda(fa):
    """Fails the run if the plain attention sees a CUDA tensor inside the
    block."""
    plain_on_cuda = []
    real_reference = fa._reference

    def guarded_reference(q, k, v, causal, scale):
        if q.is_cuda or k.is_cuda or v.is_cuda:
            plain_on_cuda.append(tuple(q.shape))
        return real_reference(q, k, v, causal, scale)

    fa._reference = guarded_reference
    try:
        yield
    finally:
        fa._reference = real_reference
    check(not plain_on_cuda,
          f"plain attention ran on CUDA tensors: {plain_on_cuda[:3]}")


def phase_slice(fa, card):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import get_bert_model
    from mxnet_tpu_torch.serving import Batcher, ModelRuntime

    def build(device):
        return get_bert_model("bert_base", vocab_size=30522, max_length=512,
                              dropout=0.0, use_decoder=False,
                              use_classifier=False, device=device)

    net = build(None)                        # the default device: the GPU
    check(next(net.parameters()).is_cuda, "model did not land on cuda")
    net.initialize(generator=torch.Generator(
        device=next(net.parameters()).device).manual_seed(0))
    telemetry.enable()
    telemetry.reset()
    t0 = time.perf_counter()
    rt = ModelRuntime(net, item_shapes=((SEQ,), (SEQ,)), dtype="int32",
                      max_batch=8)
    torch.cuda.synchronize()
    log(f"[slice] buckets {rt.buckets} warmed in "
        f"{time.perf_counter() - t0:.2f} s")
    check(rt.buckets == (1, 2, 4, 8), f"buckets {rt.buckets}")

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 30522, (N_REQUESTS, SEQ)).astype("int32")
    segments = rng.randint(0, 2, (N_REQUESTS, SEQ)).astype("int32")

    batcher = Batcher(rt, max_latency_ms=5)
    telemetry.reset()
    try:
        with no_plain_attention_on_cuda(fa):
            fa.flash_attention.launches = 0          # main path starts here
            answers, lat1, wall1 = serve(batcher,
                                         list(zip(tokens, segments)))
            launches = fa.flash_attention.launches   # main path ends here
            snap = telemetry.snapshot()
            # the same requests again: the worker thread is warm now
            _, lat2, wall2 = serve(batcher, list(zip(tokens, segments)))
    finally:
        batcher.close()

    counters = snap["counters"]
    batches = counters.get("serving.batches", 0)
    log(f"[slice] {N_REQUESTS} requests in {batches} micro-batches, "
        f"{counters.get('serving.padded_items', 0)} padded rows, "
        f"{launches} flash launches, "
        f"compile_miss {counters.get('serving.compile_miss', 0)}")
    check(counters.get("serving.batch_items") == N_REQUESTS,
          f"batch_items {counters.get('serving.batch_items')}")
    check(counters.get("serving.compile_miss", 0) == 0,
          "compile miss after warmup")
    check(batches >= 1 and launches == 12 * batches,
          f"{launches} flash launches for {batches} micro-batches "
          f"(want 12 per micro-batch)")

    # the same weights through the plain path on the CPU, in fp32
    cpu_net = build("cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_net.eval()
    with torch.inference_mode():
        seq_ref, pooled_ref = cpu_net(torch.from_numpy(tokens),
                                      torch.from_numpy(segments))
    err_seq = max(np.abs(a[0] - seq_ref[i].numpy()).max()
                  for i, a in enumerate(answers))
    err_pool = max(np.abs(a[1] - pooled_ref[i].numpy()).max()
                   for i, a in enumerate(answers))
    finite = all(np.isfinite(a[0]).all() and np.isfinite(a[1]).all()
                 for a in answers)
    log(f"[slice] vs CPU plain fp32: sequence max_abs_err {err_seq:.3e}, "
        f"pooled {err_pool:.3e} (tol 2e-3)")
    check(finite, "non-finite answer")
    check(answers[0][0].shape == (SEQ, 768) and answers[0][1].shape == (768,),
          f"answer shapes {answers[0][0].shape} {answers[0][1].shape}")
    check(err_seq <= 2e-3 and err_pool <= 2e-3,
          "served answers disagree with the CPU plain run")

    run = snap["spans"].get("serving.run", {"calls": 0, "total_ms": 0.0})
    log(f"[slice] round 1 (main path): p50 request latency "
        f"{float(np.median(lat1)):.3f} ms, max {lat1[-1]:.3f} ms, "
        f"{N_REQUESTS / wall1:.2f} requests/s, serving.run "
        f"{run['total_ms'] / max(run['calls'], 1):.3f} ms per micro-batch, "
        f"on {card}")
    log(f"[slice] round 2 (same requests, warm worker): p50 request latency "
        f"{float(np.median(lat2)):.3f} ms, max {lat2[-1]:.3f} ms, "
        f"{N_REQUESTS / wall2:.2f} requests/s, on {card}")
    profile_one_batch(rt, [(tokens[i], segments[i]) for i in range(8)])
    return launches


def profile_one_batch(rt, payloads, top=8):
    """One micro-batch of ``payloads`` through ``rt``: host wall time
    (synchronised, median of 5) and device time by kernel (CUPTI through
    torch.profiler); prints "not measured" if the trace has no device
    time."""
    from torch.autograd import DeviceType
    rows = [rt._normalize(p) for p in payloads]
    bucket = rt.bucket_for(len(rows))
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.run_batch(rows)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rt.run_batch(rows)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        log(f"[profile] {rt.name} bucket {bucket}: run_batch {wall_ms:.3f} "
            f"ms wall; device time not measured (no CUDA events in the "
            f"trace)")
        return
    log(f"[profile] {rt.name} bucket {bucket}: run_batch {wall_ms:.3f} ms "
        f"wall (median of 5), device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {len(kernels)} kernels, "
        f"{sum(e.count for e in kernels)} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


DOUBLE_K = r"""
extern "C" __global__ void double_k(const float *in0, float *out,
                                    long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = in0[i] * 2.0f;
}
"""

# Apache MXNet's mx.rtc example; AXPY_SHAPE is a multiple of 256 elements
AXPY = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
"""


def phase_rtc(card):
    """mx.rtc: compile with NVRTC, run as a user would, hold bitwise, time.
    ``--fmad=false`` keeps NVRTC from fusing ``y + alpha * x`` into one FMA
    (one rounding where the plain expression rounds twice)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, rtc
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    double = rtc.compile_cuda(DOUBLE_K, "double_k", ((8, 128), "float32"))
    t1 = time.perf_counter()
    module = rtc.CudaModule(AXPY, options=("--fmad=false",))
    axpy = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    t2 = time.perf_counter()
    log(f"[rtc] NVRTC compile + load: double_k {t1 - t0:.3f} s (NVRTC "
        f"{double.module.compile_seconds:.3f} s), axpy {t2 - t1:.3f} s "
        f"(NVRTC {module.compile_seconds:.3f} s), {len(module.cubin)} byte "
        f"cubin for {module.arch}")

    rng = np.random.RandomState(0)
    x8 = torch.from_numpy(rng.randn(8, 128).astype("float32")).to(dev)
    x = torch.from_numpy(rng.randn(*AXPY_SHAPE).astype("float32")).to(dev)
    y0 = torch.from_numpy(rng.randn(*AXPY_SHAPE).astype("float32")).to(dev)
    alpha = 0.37
    n = x.numel()
    grid, block = (n // 256,), (256,)
    y = y0.clone()
    x_nd = nd.array(x, ctx=mx.gpu(0))    # MXNet's launch takes NDArrays
    rtc.CudaKernel.launches = 0                      # main path starts here
    doubled = double(x8)
    axpy.launch([x_nd, y, alpha], dev, grid, block)
    torch.cuda.synchronize()
    launches = rtc.CudaKernel.launches               # main path ends here
    check(launches == 2, f"{launches} rtc launches (want 2)")
    err = max((doubled - x8 * 2).abs().max().item(),
              (y - (y0 + alpha * x)).abs().max().item())
    check(torch.equal(doubled, x8 * 2), "double_k differs from x * 2")
    check(torch.equal(y, y0 + alpha * x), "axpy differs from y + alpha * x")
    log(f"[rtc] double_k (8, 128) and axpy {AXPY_SHAPE} fp32 bitwise equal "
        f"to x * 2 and y + alpha * x ({launches} launches; axpy's x passed "
        f"as an mx.nd NDArray)")

    kernel_ms = device_ms(lambda: axpy.launch([x, y, alpha], dev, grid,
                                              block))
    plain_ms = device_ms(lambda: y + alpha * x)
    library_ms = device_ms(lambda: y.add_(x, alpha=alpha))
    nbytes = 3 * n * 4                    # read x and y, write y
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * n / PEAK_FLOPS[torch.float32] * 1e3
    bound_ms = max(by_bytes, by_ops)
    bound_by = "bytes" if by_bytes >= by_ops else "operations"
    log(f"[rtc] axpy {AXPY_SHAPE} fp32 ({nbytes / 1e6:.1f} MB moved): "
        f"kernel {kernel_ms:.4f} ms, plain y + alpha * x {plain_ms:.4f} ms, "
        f"y.add_(x, alpha) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), on {card}")
    return {"name": "rtc_axpy", "route": "cuda",
            "source": "mxnet_tpu_torch/rtc.py",
            "replaces": "mxnet_tpu/rtc.py:50",
            "shape": list(AXPY_SHAPE), "dtype": "float32",
            "launches": launches, "max_abs_err": err,
            "compile_s": module.compile_seconds, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def resnet_v1_symbol(sym, units, filters, classes, bottleneck=True):
    """ResNet v1 written with ``mx.sym`` calls, as a user's script writes
    it, in the model zoo's layout (``mxnet_tpu/gluon/model_zoo/vision/
    resnet.py``: a 7x7/2 stem, max pool, stages of bottleneck or basic
    units striding on their first convolution, a projection shortcut where
    the width changes, global average pool, a dense classifier) with a
    ``SoftmaxOutput`` head.  ``sym`` is the namespace (``mx.sym`` of either
    package), so one text builds the graph in both; every node with
    parameters is named, so parameter names do not depend on the process's
    auto-name counters.  ResNet-50 v1: ``units=[3, 4, 6, 3]``,
    ``filters=[64, 256, 512, 1024, 2048]``: 53 BatchNorms."""
    def conv(x, name, channels, kernel, stride, pad):
        return sym.Convolution(x, num_filter=channels, kernel=(kernel, kernel),
                               stride=(stride, stride), pad=(pad, pad),
                               no_bias=True, name=name)

    def bn(x, name):
        return sym.BatchNorm(x, fix_gamma=False, eps=1e-5, momentum=0.9,
                             name=name)

    def relu(x, name):
        return sym.Activation(x, act_type="relu", name=name)

    x = sym.Variable("data")
    x = relu(bn(conv(x, "conv0", filters[0], 7, 2, 3), "bn0"), "relu0")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max", name="pool0")
    for i, n in enumerate(units):
        for j in range(n):
            name, c = f"stage{i + 1}_unit{j + 1}", filters[i + 1]
            stride = 2 if i > 0 and j == 0 else 1
            if bottleneck:
                y = relu(bn(conv(x, name + "_conv1", c // 4, 1, stride, 0),
                            name + "_bn1"), name + "_relu1")
                y = relu(bn(conv(y, name + "_conv2", c // 4, 3, 1, 1),
                            name + "_bn2"), name + "_relu2")
                y = bn(conv(y, name + "_conv3", c, 1, 1, 0), name + "_bn3")
            else:
                y = relu(bn(conv(x, name + "_conv1", c, 3, stride, 1),
                            name + "_bn1"), name + "_relu1")
                y = bn(conv(y, name + "_conv2", c, 3, 1, 1), name + "_bn2")
            if j == 0 and c != filters[i]:
                x = bn(conv(x, name + "_sc", c, 1, stride, 0), name + "_sc_bn")
            x = relu(x + y, name + "_relu")
    x = sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1),
                    name="pool1")
    x = sym.FullyConnected(sym.Flatten(x, name="flatten0"), num_hidden=classes,
                           name="fc1")
    return sym.SoftmaxOutput(x, name="softmax")


def _seeded(name, shape, rng):
    """Seeded values by parameter name: BatchNorm statistics with variance
    > 0, He-scaled weights; gammas under one keep 16 residual blocks from
    growing the logits past O(1)."""
    if name.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if name.endswith(("running_mean", "beta", "bias")):
        return rng.normal(0, 0.1, shape)
    if name.endswith("gamma"):
        return rng.uniform(0.2, 0.6, shape)
    return rng.normal(0, math.sqrt(2.0 / math.prod(shape[1:])), shape)


def phase_resnet(card):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.serving import Batcher, ModelRuntime

    # the weights: seeded on the CPU net (a tiny forward fixes the deferred
    # widths), carried onto the card through a .params file
    t0 = time.perf_counter()
    cpu_net = get_model("resnet50_v1", classes=1000, device="cpu").eval()
    with torch.inference_mode():
        cpu_net(torch.zeros(1, 3, 32, 32))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, t in sorted(cpu_net._collect_params_with_prefix()
                              .items()):
            t.copy_(torch.from_numpy(_seeded(name, tuple(t.shape), rng)
                                     .astype("float32")))
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / "resnet50_v1.params"
    cpu_net.save_parameters(str(path))
    net = get_model("resnet50_v1", classes=1000)   # the default: the GPU
    net.load_parameters(str(path))
    n_params = sum(p.numel() for p in net.parameters())
    check(all(t.is_cuda for t in net._collect_params_with_prefix().values()),
          "resnet parameters did not land on cuda")
    log(f"[resnet] resnet50_v1: {n_params} parameters, seeded and loaded "
        f"onto the card in {time.perf_counter() - t0:.2f} s")

    telemetry.enable()
    telemetry.reset()
    t0 = time.perf_counter()
    rt = ModelRuntime(net, item_shapes=IMAGE, max_batch=8)
    torch.cuda.synchronize()
    log(f"[resnet] buckets {rt.buckets} warmed in "
        f"{time.perf_counter() - t0:.2f} s")
    check(rt.buckets == (1, 2, 4, 8), f"buckets {rt.buckets}")

    images = np.random.RandomState(1).randn(N_REQUESTS, *IMAGE) \
        .astype("float32")
    batcher = Batcher(rt, max_latency_ms=5)
    telemetry.reset()
    try:
        answers, lat1, wall1 = serve(batcher, list(images))
        snap = telemetry.snapshot()
        _, lat2, wall2 = serve(batcher, list(images))
    finally:
        batcher.close()
    counters = snap["counters"]
    batches = counters.get("serving.batches", 0)
    log(f"[resnet] {N_REQUESTS} requests in {batches} micro-batches, "
        f"{counters.get('serving.padded_items', 0)} padded rows, "
        f"compile_miss {counters.get('serving.compile_miss', 0)}")
    check(counters.get("serving.batch_items") == N_REQUESTS,
          f"batch_items {counters.get('serving.batch_items')}")
    check(counters.get("serving.compile_miss", 0) == 0,
          "compile miss after warmup")

    from mxnet_tpu_torch.gluon.nn import Conv2D
    flops = []                 # 2 * outputs * (C_in / groups * kH * kW)
    hooks = [m.register_forward_hook(
        lambda m, i, o: flops.append(2 * o.numel() * m.weight[0].numel()))
        for m in cpu_net.modules() if isinstance(m, Conv2D)]
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_net(torch.from_numpy(images)).numpy()
    cpu_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    log(f"[resnet] convolutions: {len(flops)} per forward, "
        f"{sum(flops) * 8 / N_REQUESTS / 1e9:.2f} GFLOP per bucket-8 "
        f"micro-batch")
    out = np.stack(answers)
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    log(f"[resnet] vs CPU plain fp32 ({cpu_s:.2f} s): logits max_abs_err "
        f"{err:.3e}, max|logit| {scale:.3f}, relative {err / scale:.3e} "
        f"(tol 1e-3), answer std {float(out.std()):.4f}")
    check(out.shape == (N_REQUESTS, 1000), f"answer shape {out.shape}")
    check(np.isfinite(out).all(), "non-finite logits")
    check(all(float(a.std()) > 0 for a in answers), "a constant answer")
    check(err <= 1e-3 * scale,
          "served logits disagree with the CPU plain run")

    run = snap["spans"].get("serving.run", {"calls": 0, "total_ms": 0.0})
    log(f"[resnet] round 1 (main path, fresh worker): p50 request latency "
        f"{float(np.median(lat1)):.3f} ms, max {lat1[-1]:.3f} ms, "
        f"{N_REQUESTS / wall1:.2f} requests/s, serving.run "
        f"{run['total_ms'] / max(run['calls'], 1):.3f} ms per micro-batch, "
        f"on {card}")
    log(f"[resnet] round 2 (same requests, warm worker): p50 request "
        f"latency {float(np.median(lat2)):.3f} ms, max {lat2[-1]:.3f} ms, "
        f"{N_REQUESTS / wall2:.2f} requests/s, on {card}")
    profile_one_batch(rt, list(images[:8]), top=10)
    telemetry.disable()
    return path


def phase_bn_kernel(bs, card):
    """The bn-stats kernel against its plain version, and its times per
    fp32 geometry; returns ({shape: (kernel, plain, var_mean, bound ms,
    bound_by, tickets ms)}, {shape: (fp16 kernel, bound ms, bound_by,
    tickets ms)}, the largest fp32 error at those shapes, the largest fp16
    error); "tickets ms" is the same launch folding through the tickets
    where the plan took a cluster, else None."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(s, dt, 0.0, 0.5) for s in RESNET50_BN
             for dt in (torch.float32, torch.bfloat16, torch.float16)]
    cases += [((3, 5, 7, 9), torch.float32, 0.0, 0.5),
              ((3, 5, 7, 9), torch.float16, 0.0, 0.5),
              ((8, 16, 28, 28), torch.float32, 1000.0, 1.0),
              ((8, 16, 28, 28), torch.bfloat16, 1000.0, 1.0),
              ((8, 16, 28, 28), torch.float16, 1000.0, 1.0)]
    times, fp16_times, path_err, fp16_err = {}, {}, 0.0, 0.0
    for shape, dtype, mean, std in cases:
        x = (torch.randn(shape, generator=gen, device=dev) * std + mean) \
            .to(dtype)
        pivot = x[0, :, 0, 0].float().contiguous()
        m, v = bs.bn_stats(x, pivot)
        torch.cuda.synchronize()
        rm, rv = bs._reference(x, pivot)
        err = max((m - rm).abs().max().item(), (v - rv).abs().max().item())
        tol = 2e-5 if mean == 0.0 else 1e-4
        check(m.dtype == v.dtype == torch.float32 and
              m.shape == v.shape == (shape[1],),
              f"bn_stats output {m.dtype} {tuple(m.shape)}")
        check(math.isfinite(err) and err <= tol,
              f"bn_stats disagrees with plain version at {shape} {dtype} "
              f"mean {mean}: {err}")
        line = (f"[bn_stats] {shape} {str(dtype)[6:]} mean {mean:g}: "
                f"max_abs_err {err:.3e} (tol {tol:g})")
        part, plan = bn_first_pivot_same(bs, x, 1, m, v)
        line += part
        if dtype == torch.float16:
            fp16_err = max(fp16_err, err)
            if shape in RESNET50_BN:
                k16 = device_ms(lambda: bs.bn_stats(x, bs.FIRST))
                b16, by16 = bn_stats_bound_ms(shape, dtype)
                t16 = bn_tickets_ms(bs, x, 1, plan)
                fp16_times[shape] = (k16, b16, by16, t16)
                line += (f"; kernel {k16:.4f} ms, bound {b16:.4f} ms "
                         f"({by16}), {b16 / k16:.2f} of the bound")
                line += bn_tickets_part(t16, k16)
        if shape in RESNET50_BN and dtype == torch.float32:
            path_err = max(path_err, err)
            k = device_ms(lambda: bs.bn_stats(x, bs.FIRST))
            pl = device_ms(lambda: bs._reference(x, pivot))
            lib = device_ms(lambda: torch.var_mean(x, dim=(0, 2, 3),
                                                   unbiased=False))
            bound, by = bn_stats_bound_ms(shape, dtype)
            t = bn_tickets_ms(bs, x, 1, plan)
            times[shape] = (k, pl, lib, bound, by, t)
            line += (f"; kernel {k:.4f} ms, plain {pl:.4f} ms, var_mean "
                     f"{lib:.4f} ms, bound {bound:.4f} ms ({by}), "
                     f"{bound / k:.2f} of the bound")
            line += bn_tickets_part(t, k)
        log(line)
    log(f"[bn_stats] timed on {card}, inputs warm in L2 where they fit "
        f"(the real caller reads what the convolution just wrote), the "
        f"kernel reading its own pivot (bs.FIRST, as the main path); fp16 "
        f"max_abs_err {fp16_err:.3e}")
    bn_wrapper_host("[bn_stats]", bs, (32, 256, 14, 14), 1)
    return times, fp16_times, path_err, fp16_err


def bn_first_pivot_same(bs, x, axis, m, v):
    """Checks that the kernel reading its own pivot (``bs.FIRST``, the
    main path's call) gives the bits of the explicit pivot tensor ``m, v``
    were computed with, and that a second call gives them again; returns
    the plan it launched, as a log line's part and as the kernel gave it."""
    m1, v1, plan = bs.plan(x, bs.FIRST, axis)
    m2, v2 = bs.bn_stats(x, bs.FIRST, axis)
    check(torch.equal(m, m1) and torch.equal(v, v1),
          f"bn_stats with the kernel's own pivot differs from the explicit "
          f"pivot at {tuple(x.shape)} {x.dtype}")
    check(torch.equal(m1, m2) and torch.equal(v1, v2),
          f"bn_stats is not deterministic at {tuple(x.shape)} {x.dtype}")
    route = "wide" if plan["wide"] else "rows"
    fold = " (cluster)" if plan["cluster"] else ""
    return (f"; own pivot == explicit, bitwise; plan {route} "
            f"V={plan['vec']} G={plan['group']} S={plan['splits']}{fold}",
            plan)


def bn_tickets_ms(bs, x, axis, plan):
    """Where ``plan`` folds its slices in a thread-block cluster: the
    device ms of the same launch folding them through the tickets (the
    fold of larger S), else None."""
    if not plan["cluster"]:
        return None
    return device_ms(lambda: bs.plan(x, bs.FIRST, axis,
                                     splits=plan["splits"], tickets=True))


def bn_tickets_part(tickets_ms, ms):
    """The log line's part comparing the cluster fold with the tickets."""
    if tickets_ms is None:
        return ""
    return (f"; the same S through the tickets {tickets_ms:.4f} ms "
            f"({tickets_ms / ms:.2f}x the cluster fold's)")


def bn_wrapper_host(tag, bs, shape, axis, calls=200):
    """Host microseconds a call of ``batch_stats`` (the training path's
    autograd node around the kernel), forward and forward plus backward,
    by ``time.perf_counter`` over ``calls`` calls on a warm input without
    the profiler; the input is small, so that the host, not the device,
    sets the pace."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(shape, generator=gen, device=dev).requires_grad_()
    gm, gv = (torch.randn(shape[axis], generator=gen, device=dev)
              for _ in range(2))

    def forward():
        return bs.batch_stats(x, bs.FIRST, axis)

    def forward_backward():
        torch.autograd.backward(forward(), (gm, gv))

    us = []
    for fn in (forward, forward_backward):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        us.append(((t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6))
    log(f"{tag} wrapper host time at {shape} (axis {axis}), {calls} warm "
        f"calls: batch_stats forward {us[0][0]:.1f} us a call (until the "
        f"device is done {us[0][1]:.1f}), forward and backward "
        f"{us[1][0]:.1f} us a call (until done {us[1][1]:.1f})")
    return us


@contextlib.contextmanager
def no_plain_stats_on_cuda(bs):
    """Fails the run if the plain bn statistics see a CUDA tensor inside
    the block."""
    plain_on_cuda = []
    real_reference = bs._reference

    def guarded_reference(x, pivot=None, axis=1):
        if x.is_cuda:
            plain_on_cuda.append(tuple(x.shape))
        return real_reference(x, pivot, axis)

    bs._reference = guarded_reference
    try:
        yield
    finally:
        bs._reference = real_reference
    check(not plain_on_cuda,
          f"plain bn statistics ran on CUDA tensors: {plain_on_cuda[:3]}")


def _train(net, x, y, steps, amp_on=False, opt=None):
    """``steps`` SGD steps of the user's loop; returns (per-step losses,
    the gradients of step 1, final parameters and running statistics),
    all on the host, as float32.  ``amp_on``: under ``amp.init()`` with
    ``amp.init_trainer`` and ``amp.scale_loss``, the gradients unscaled;
    ``opt`` replaces phase 8's optimizer settings."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.contrib import amp
    params = net.collect_params()
    trainer = gluon.Trainer(params, "sgd", dict(opt or TRAIN_OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, grads = [], None
    if amp_on:
        amp.init()
        amp.init_trainer(trainer)
    try:
        for step in range(steps):
            with autograd.record():
                loss = loss_fn(net(x), y)
                if amp_on:
                    with amp.scale_loss(loss, trainer) as scaled:
                        autograd.backward(scaled)
            if not amp_on:
                autograd.backward(loss)
            losses.append(loss.detach().float().cpu().numpy())
            if step == 0:
                scale = trainer._amp_loss_scaler.loss_scale if amp_on \
                    else 1.0
                grads = {k: p.grad().float().cpu().numpy() / scale
                         for k, p in params.items() if p.grad_req != "null"}
            trainer.step(x.shape[0])
    finally:
        amp.deinit()
    return losses, grads, {k: p.data().detach().float().cpu().numpy()
                           for k, p in params.items()}


def _rel(a, b):
    """(the largest over tensors of max |a - b| / max |b|, its tensor)."""
    check(sorted(a) == sorted(b) and a, "compared runs differ in tensors")
    return max((float(np.abs(a[k] - b[k]).max()) /
                max(float(np.abs(b[k]).max()), 1e-30), k) for k in b)


def _images(rng, batch, layout):
    """A seeded batch of (3, 224, 224) images in ``layout``."""
    x = rng.randn(batch, *IMAGE).astype("float32")
    return x if layout == "NCHW" else np.ascontiguousarray(
        x.transpose(0, 2, 3, 1))


def phase_train_parity(bs, path, layout="NCHW", steps=PARITY_STEPS):
    """``steps`` SGD steps at batch 8 on the card against the CPU plain
    path, with 53 kernel launches per forward and no plain statistics on
    the card; in NHWC (phase 21) all on the channels-last entry, with no
    copy of a BatchNorm input."""
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    tag = "[train]" if layout == "NCHW" else "[nhwc]"
    rng = np.random.RandomState(2)
    x = _images(rng, PARITY_BATCH, layout)
    y = rng.randint(0, 1000, PARITY_BATCH).astype("float32")
    perm = np.roll(np.arange(PARITY_BATCH), 3)

    def cpu_run(order):
        net = get_model("resnet50_v1", classes=1000, layout=layout,
                        device="cpu")
        net.load_parameters(str(path))
        run = _train(net, torch.from_numpy(x[order]),
                     torch.from_numpy(y[order]), steps)
        return [l[np.argsort(order)] for l in run[0]], run[1], run[2]

    t0 = time.perf_counter()
    ref = cpu_run(np.arange(PARITY_BATCH))
    again = cpu_run(perm)
    cpu_s = time.perf_counter() - t0

    net = get_model("resnet50_v1", classes=1000, layout=layout)  # the GPU
    net.load_parameters(str(path))
    with no_plain_stats_on_cuda(bs):
        bs.bn_stats.launches = 0                 # the parity path starts
        bs.bn_stats.launches_cl = bs.bn_stats.copies = 0
        card = _train(net, torch.from_numpy(x).cuda(),
                      torch.from_numpy(y).cuda(), steps)
        torch.cuda.synchronize()
        launches = bs.bn_stats.launches          # the parity path ends
        launches_cl, copies = bs.bn_stats.launches_cl, bs.bn_stats.copies
    check(launches == BN_PER_FORWARD * steps,
          f"{launches} bn-stats launches for {steps} training "
          f"forwards (want {BN_PER_FORWARD} each)")
    want_cl = launches if layout == "NHWC" else 0
    check(launches_cl == want_cl and copies == 0,
          f"{tag} {launches_cl} channels-last launches (want {want_cl}), "
          f"{copies} copied BatchNorm inputs (want 0)")
    log(f"{tag} parity: 2 CPU plain runs of {steps} steps at batch "
        f"{PARITY_BATCH} ({layout}) in {cpu_s:.1f} s; card: {launches} "
        f"bn-stats launches ({BN_PER_FORWARD} per forward, {launches_cl} "
        f"on the channels-last entry, {copies} copies), none of the plain "
        f"version")
    quantities = [(f"loss of step {i + 1}", lambda r, i=i: {"l": r[0][i]})
                  for i in range(steps)]
    quantities += [("step-1 gradients", lambda r: r[1]),
                   (f"parameters and running statistics after step "
                    f"{steps}", lambda r: r[2])]
    for what, pick in quantities:
        spread, spread_at = _rel(pick(again), pick(ref))
        tol = max(1e-4, 2 * spread)
        err, err_at = _rel(pick(card), pick(ref))
        log(f"{tag} {what}: card vs CPU {err:.3e} of the tensor's max "
            f"(worst {err_at}), CPU vs CPU reordered {spread:.3e} (worst "
            f"{spread_at}), tol {tol:.3e}")
        check(all(np.isfinite(v).all() for v in pick(card).values()),
              f"non-finite {what}")
        check(err <= tol, f"card training disagrees with the CPU plain run: "
                          f"{what}")
    log(f"{tag} losses, card: {[float(l.mean()) for l in card[0]]}, "
        f"CPU: {[float(l.mean()) for l in ref[0]]}")


def phase_train(bs, path, card, amp_on=False, layout="NCHW"):
    """The main path at full width: batch 32, 3 warm and 10 timed steps;
    returns (launches, {BatchNorm input shape: count per forward}, step
    ms, peak bytes).  ``amp_on`` (phase 18): the same under ``amp.init()``
    with ``init_trainer`` and ``scale_loss``; every bn-stats launch must
    read fp32 (BatchNorm is on AMP's fp32 list).  ``layout="NHWC"``
    (phase 22): the NHWC net, every launch on the channels-last entry and
    no BatchNorm input copied."""
    from mxnet_tpu_torch import autograd, gluon, telemetry
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    tag, precision = ("[amp_train]", "AMP bf16") if amp_on \
        else ("[train]", "fp32")
    if layout == "NHWC":
        tag = tag.replace("[", "[nhwc_")

    net = get_model("resnet50_v1", classes=1000, layout=layout)
    net.load_parameters(str(path))
    bn_shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda m, i: bn_shapes.append(tuple(i[0].shape)))
        for m in net.modules() if isinstance(m, BatchNorm)]
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_images(rng, TRAIN_BATCH, layout)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, TRAIN_BATCH)
                         .astype("float32")).cuda()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(TRAIN_OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    if amp_on:
        amp.init()
        amp.init_trainer(trainer)

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
            if amp_on:
                with amp.scale_loss(loss, trainer) as scaled:
                    autograd.backward(scaled)
        if not amp_on:
            autograd.backward(loss)
        trainer.step(TRAIN_BATCH)
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    telemetry.enable()
    telemetry.reset()
    with no_plain_stats_on_cuda(bs), kernel_dtypes(bs) as seen:
        bs.bn_stats.launches = 0                 # the main path starts
        bs.bn_stats.launches_cl = bs.bn_stats.copies = 0
        t0 = time.perf_counter()
        losses = [step() for _ in range(WARM_STEPS)]
        # a full collection of what the earlier phases left (~300k tracked
        # objects, ~150 ms of host time) runs here, not in a timed step
        gc.collect()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for h in hooks:
            h.remove()
        for _ in range(TIMED_STEPS):
            losses.append(step())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = bs.bn_stats.launches          # the main path ends
        launches_cl, copies = bs.bn_stats.launches_cl, bs.bn_stats.copies
    snap = telemetry.snapshot()
    telemetry.disable()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(l.mean()) for l in losses]
    steps = WARM_STEPS + TIMED_STEPS
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    # the same batch every step: training must bring its loss down
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == BN_PER_FORWARD * steps,
          f"{launches} bn-stats launches in {steps} steps")
    check(set(seen) == {torch.float32},
          f"bn-stats launched on {set(seen)} inputs (want float32)")
    check(len(bn_shapes) == BN_PER_FORWARD * WARM_STEPS,
          f"{len(bn_shapes)} BatchNorm calls in {WARM_STEPS} forwards")
    want_cl = launches if layout == "NHWC" else 0
    check(launches_cl == want_cl and copies == 0,
          f"{tag} {launches_cl} channels-last launches (want {want_cl}), "
          f"{copies} copied BatchNorm inputs (want 0)")
    step_ms = (t2 - t1) * 1e3 / TIMED_STEPS
    upd = snap["spans"].get("trainer.update", {"calls": 1, "total_ms": 0.0})
    log(f"{tag} resnet50_v1 {layout} batch {TRAIN_BATCH} {precision} "
        f"(TF32 off): "
        f"{WARM_STEPS} warm steps {(t1 - t0) * 1e3:.1f} ms, {TIMED_STEPS} "
        f"timed steps {step_ms:.3f} ms each, "
        f"{TRAIN_BATCH * 1e3 / step_ms:.2f} images/s; peak device memory "
        f"{peak / 2**30:.3f} GiB; {launches} bn-stats launches "
        f"({BN_PER_FORWARD} per step, {launches_cl} on the channels-last "
        f"entry, {copies} copies); trainer.update "
        f"{upd['total_ms'] / max(upd['calls'], 1):.3f} ms host per step; "
        f"on {card}")
    log(f"{tag} mean loss per step: {[round(l, 4) for l in losses]}")
    try:
        check_bn_calls(bs, step, tag)
        profile_train_step(step, step_ms)
    finally:
        amp.deinit()
    counts = {}
    for shape in bn_shapes[:BN_PER_FORWARD]:
        counts[shape] = counts.get(shape, 0) + 1
    return launches, counts, step_ms, peak


@contextlib.contextmanager
def bn_launch_hook(bs, hook):
    """Calls ``hook(x, pivot, axis, mean, var)`` after every launch of the
    bn-stats kernel inside the block (the wrapper's counts are kept)."""
    real = bs._launch

    def hooked(x, pivot, kind, axis, *rest):
        mean, var = real(x, pivot, kind, axis, *rest)
        hook(x, pivot, axis, mean, var)
        return mean, var

    bs._launch = hooked
    try:
        yield
    finally:
        bs._launch = real


def check_bn_calls(bs, step, tag):
    """One more training step in which the statistics of every bn-stats
    launch are held against the plain version on the same input (1e-4 of
    max(1, |mean|, var), phase 7's tolerance at mean 1000): the kernel ran,
    and ran right, at each of the path's BatchNorm inputs."""
    errs = []

    def compare(x, pivot, axis, mean, var):
        rm, rv = bs._reference(x, pivot, axis)
        scale = max(1.0, rm.abs().max().item(), rv.max().item())
        errs.append((max((mean - rm).abs().max().item(),
                         (var - rv).abs().max().item()) / scale,
                     tuple(x.shape)))

    with bn_launch_hook(bs, compare):
        step()
    torch.cuda.synchronize()
    worst = max(errs)
    check(len(errs) == BN_PER_FORWARD and all(math.isfinite(e) and e <= 1e-4
                                              for e, _ in errs),
          f"{tag} {len(errs)} bn-stats launches in a checked step (want "
          f"{BN_PER_FORWARD}), worst {worst}")
    log(f"{tag} every bn-stats launch of one step against the plain "
        f"version: {len(errs)} launches, worst error {worst[0]:.3e} of "
        f"max(1, |mean|, var) at {worst[1]} (tol 1e-4)")


def _trace_gaps(prof):
    """What a trace holds against what was launched: the runtime launches
    with no kernel record, by their place among the step's launches and
    API name.  Reads the trace's JSON export."""
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / "profile_trace.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    kernels = {e["args"].get("correlation"): e["name"] for e in events
               if e.get("cat") == "kernel"}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "Launch" in e.get("name", "")),
                      key=lambda e: e["ts"])
    lost = [(i, e["name"]) for i, e in enumerate(launches)
            if e["args"].get("correlation") not in kernels]
    return (f"{len(launches)} runtime launches, {len(kernels)} kernel "
            f"records ({sum('bn_stats' in k for k in kernels.values())} "
            f"bn_stats); launches with no kernel record: {lost[:12]}")


def profile_train_step(step, step_ms, top=12):
    """Device time by kernel over one training step (CUPTI through
    torch.profiler) beside the timed steps' mean wall time.  A step under
    the profiler's warm-up comes first: a trace started at the step lost
    the records of its first ~10 kernels, which in the NHWC step hold its
    first ``bn_stats`` launch."""
    from torch.autograd import DeviceType
    from mxnet_tpu_torch.ops import bn_stats
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    warm_then_record = torch.profiler.schedule(wait=0, warmup=1, active=1,
                                               repeat=1)
    with torch.profiler.profile(activities=acts,
                                schedule=warm_then_record) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        calls = bn_stats.bn_stats.launches
        step()
        torch.cuda.synchronize()
        prof.step()
    calls = bn_stats.bn_stats.launches - calls
    check(calls == BN_PER_FORWARD, f"{calls} bn-stats calls in the profiled "
                                   f"step (want {BN_PER_FORWARD})")
    # the schedule's "ProfilerStep#" range spans the step on the host and
    # on the device: it is neither a kernel nor a host op of the step
    events = [e for e in prof.key_averages()
              if not e.key.startswith("ProfilerStep")]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        log(f"[profile] train step: {step_ms:.3f} ms wall; device time not "
            f"measured (no CUDA events in the trace)")
        return
    bn_ms = sum(e.self_device_time_total for e in kernels
                if "bn_stats" in e.key) / 1e3
    bn_launches = sum(e.count for e in kernels if "bn_stats" in e.key)
    log(f"[profile] train step batch {TRAIN_BATCH}: {step_ms:.3f} ms wall "
        f"(mean of {TIMED_STEPS}), device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / step_ms:.3f}, {len(kernels)} kernels, "
        f"{sum(e.count for e in kernels)} launches; bn-stats kernels "
        f"{bn_ms:.3f} ms ({bn_ms / busy_ms:.3f} of busy), {bn_launches} "
        f"launches for the step's {calls} calls; "
        f"{_kernel_share(kernels, busy_ms)}")
    if bn_launches != calls:
        log(f"[profile] the trace holds {bn_launches} bn_stats kernel "
            f"records for the step's {calls} calls: {_trace_gaps(prof)}")
    check(bn_launches == calls,
          f"{bn_launches} bn_stats kernels for {calls} calls in one training "
          f"step (want one launch a call)")
    log(f"[profile] train step convolutions by kind: "
        f"{_conv_kinds(kernels)}")
    host_ops = [e for e in events if e.device_type != DeviceType.CUDA]
    host = sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:6]
    log("[profile] train step host ops by self CPU ms: " + ", ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} x{e.count}"
        for e in host))
    wrapper = [e for e in host_ops if "_BatchStats" in e.key]
    log("[profile] train step bn-stats wrapper by self CPU ms: " + (
        ", ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} "
                  f"x{e.count}" for e in wrapper) or "not in the trace"))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def _conv_kinds(kernels):
    """Device ms of cuDNN's convolution kernels by pass (forward, data and
    weight gradient: ``fprop``/``dgrad``/``wgrad`` in their names) and the
    other kernels whose names say convolution; bf16/fp16 tensor-core
    engines name their operand type, fp32 FMA engines ``ffma``/``simt``."""
    out = {}
    for e in kernels:
        k = e.key.lower()
        kind = next((w for w in ("fprop", "dgrad", "wgrad") if w in k),
                    "other conv" if "conv" in k else None)
        if kind is None:
            continue
        unit = "fp32 FMA" if any(w in k for w in ("ffma", "simt")) else \
            "tensor cores" if any(w in k for w in ("bf16", "f16", "hmma",
                                                   "tf32", "xmma", "wgmma",
                                                   "gmma")) else "other"
        key = f"{kind} ({unit})"
        out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3
    return ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(out.items())) \
        or "none named"


def bn_record(times, fp16_times, counts, err, fp16_err, launches,
              name="bn_stats"):
    """The bn-stats kernel's JSON record (``name``: its NCHW entry, or
    ``bn_stats_cl``, the channels-last one): times summed over the
    BatchNorm inputs of one batch-32 forward (fp32, and the kernel's fp16
    time and bound at the same inputs)."""
    check(set(counts) == set(times),
          f"BatchNorm geometries {sorted(counts)} differ from the timed "
          f"ones {sorted(times)}")
    total = [sum(times[s][i] * n for s, n in counts.items())
             for i in range(4)]
    by = {times[s][4] for s in counts}
    check(len(by) == 1, f"bounds of mixed kinds {by}")
    fp16 = [sum(fp16_times[s][i] * n for s, n in counts.items())
            for i in range(2)]
    # the same sums with the tickets folding where the plan took a cluster
    tickets = [sum((t[j] if t[j] is not None else t[0]) * n
                   for s, n in counts.items() for t in [ts[s]])
               for ts, j in ((times, 5), (fp16_times, 3))]
    log(f"[{name}] one batch-{TRAIN_BATCH} forward ({sum(counts.values())}"
        f" launches): kernel {total[0]:.4f} ms, plain {total[1]:.4f} ms, "
        f"var_mean {total[2]:.4f} ms, bound {total[3]:.4f} ms "
        f"({total[3] / total[0]:.3f} of it); fp16 kernel {fp16[0]:.4f} ms, "
        f"bound {fp16[1]:.4f} ms ({fp16[1] / fp16[0]:.3f} of it); with the "
        f"tickets in place of the cluster fold {tickets[0]:.4f} ms fp32, "
        f"{tickets[1]:.4f} ms fp16")
    layout = "NHWC" if name == "bn_stats_cl" else "NCHW"
    return {"name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/bn_stats.cu",
            "replaces": "benchmark/pallas_bn_stats.py:91",
            "shape": f"the {sum(counts.values())} BatchNorm inputs of one "
                     f"batch-{TRAIN_BATCH} {layout} ResNet-50 v1 forward; "
                     f"ms summed",
            "dtype": "float32", "launches": launches, "max_abs_err": err,
            "fp16_max_abs_err": fp16_err, "fp16_ms": fp16[0],
            "fp16_bound_ms": fp16[1], "ms": total[0],
            "kernel_ms": total[0], "plain_ms": total[1],
            "bound_ms": total[3],
            "bound_by": by.pop(),
            "library_ms": total[2]}


def synth_batch(rng, batch, seq, vocab, n_masked):
    """``example/bert/pretrain.py``'s synthetic MLM+NSP batch (copied: the
    script imports nothing of the example)."""
    tokens = rng.randint(4, vocab, (batch, seq))
    segments = (np.arange(seq)[None, :] >= seq // 2).astype("int32") * \
        np.ones((batch, 1), "int32")
    valid = np.ones((batch, seq), dtype="float32")
    positions = np.stack([rng.choice(seq, n_masked, replace=False)
                          for _ in range(batch)])
    mlm_labels = np.take_along_axis(tokens, positions, axis=1)
    tokens_masked = tokens.copy()
    np.put_along_axis(tokens_masked, positions, 3, axis=1)  # [MASK]=3
    nsp_labels = rng.randint(0, 2, (batch,))
    return (tokens_masked.astype("int32"), segments, valid,
            positions.astype("int32"), mlm_labels.astype("float32"),
            nsp_labels.astype("float32"))


def _bert(layers, device):
    from mxnet_tpu_torch.models import get_bert_model
    return get_bert_model("bert_base", vocab_size=VOCAB, max_length=512,
                          dropout=0.0, num_layers=layers, device=device)


def _pretrain_step_fn(net, batch, trainer, on_grads=None):
    """One step of the user's loop (``example/bert/pretrain.py``'s
    ``step``) on ``batch`` = (tokens, segments, valid_mask or None,
    positions, mlm labels, nsp labels), tensors on the net's device;
    ``on_grads()`` runs between the backward and the update.  A trainer
    with AMP's loss scaler (``amp.init_trainer``) takes the backward
    through ``amp.scale_loss``, as MXNet's AMP examples write it."""
    from mxnet_tpu_torch import autograd, gluon
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    from mxnet_tpu_torch.contrib import amp
    tok, seg, valid, pos, mlm_y, nsp_y = batch
    scaled_loss = getattr(trainer, "_amp_loss_scaler", None) is not None

    def step():
        with autograd.record():
            _, _, mlm, nsp = net(tok, seg, valid, pos)
            loss = sce(mlm.reshape(-1, VOCAB), mlm_y.reshape(-1)).mean() + \
                sce(nsp, nsp_y).mean()
            if scaled_loss:
                with amp.scale_loss(loss, trainer) as scaled:
                    autograd.backward(scaled)
        if not scaled_loss:
            autograd.backward(loss)
        if on_grads is not None:
            on_grads()
        trainer.step(tok.shape[0])
        return loss.detach()
    return step


def _pretrain(net, batch, steps):
    """``steps`` Adam steps; returns (losses, the gradients of every step,
    the final parameters), all on the host."""
    from mxnet_tpu_torch import gluon
    params = net.collect_params()
    trainer = gluon.Trainer(params, "adam", {"learning_rate": PRETRAIN_LR})
    grads = []
    step = _pretrain_step_fn(net, batch, trainer, lambda: grads.append(
        {k: p.grad().cpu().numpy().copy() for k, p in params.items()}))
    losses = [float(step().cpu()) for _ in range(steps)]
    return losses, grads, {k: p.data().detach().cpu().numpy()
                           for k, p in params.items()}


def adam_allowance(grads, ref_grads, lr):
    """Per element, how far apart two runs' Adam steps may take it given
    how far apart their gradients were.  Adam's step ``lr * m / sqrt(v)``
    is scale-free in the gradient: where the gradients of steps 1..s part
    by a fraction R_s of the reference's, the step-s moves part by at most
    about 2 R_s lr, and by 2 lr once R_s >= 1 (the sign itself).  So an
    element whose gradient is rounding noise (the attention's key bias, zero
    in exact arithmetic) may part by 2 lr a step, and one whose gradient
    the runs agree on to 1e-6 by 2e-6 lr."""
    out, worst = {}, {}
    for g, r in zip(grads, ref_grads):
        for k in r:
            with np.errstate(divide="ignore", invalid="ignore"):
                frac = np.abs(g[k] - r[k]) / np.abs(r[k])
            frac = np.nan_to_num(frac, nan=0.0, posinf=1.0)
            worst[k] = np.maximum(worst.get(k, 0.0), np.minimum(frac, 1.0))
            out[k] = out.get(k, 0.0) + 2 * lr * worst[k]
    return out


def _key_bias(name, shape):
    """Mask of the attention key-bias elements of parameter ``name``: the
    middle third of each layer's ``qkv.bias``.  Their gradient is zero in
    exact arithmetic (a key bias shifts each score row by a constant, which
    softmax ignores), so each run's is rounding noise."""
    mask = np.zeros(shape, dtype=bool)
    if name.endswith("attention.qkv.bias"):
        mask[shape[0] // 3:2 * shape[0] // 3] = True
    return mask


def _adam_param_check(what, card, ref, again, grads, zero_init):
    """Parameters after ``steps`` Adam steps, card against CPU: each
    element within 1e-4 of its tensor's max, or twice the CPU run's own
    spread under a reordered batch where that is larger, plus the element's
    :func:`adam_allowance`.  The spread is the reordered run's distance
    past its own allowance.  ``grads`` holds every step's gradients of the
    (card, CPU, reordered CPU) runs, each step's already held within the
    gradient tolerance, so a large allowance is granted only where the
    gradient is small against its tensor's largest.  The elements that
    rely on the allowance are counted: any number of key-bias elements
    (:func:`_key_bias`; the gradient check bounds their card gradient at
    rounding level) and at most ``ALLOWANCE_CAP`` others, all in the
    tensors named in ``zero_init``.  Those start at zero, so after a few
    Adam steps their largest element, which scales the tolerance, is
    itself a few lr; a tensor that starts at its initial weights may have
    no element that needs the allowance."""
    card_g, ref_g, again_g = grads
    allow = adam_allowance(card_g, ref_g, PRETRAIN_LR)
    allow_again = adam_allowance(again_g, ref_g, PRETRAIN_LR)
    spread = (0.0, "")
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        past = np.abs(again[k] - r) - allow_again[k]
        spread = max(spread, (float(past.max(initial=0.0)) / scale, k))
    tol = max(1e-4, 2 * spread[0])
    err, n_key, n_other, others, n_weight = (0.0, ""), 0, 0, {}, 0
    far, far_allow = 0.0, 0.0
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        d = np.abs(card[k] - r)
        err = max(err, (float((d - allow[k]).max(initial=0.0)) / scale, k))
        past = d > tol * scale
        key = _key_bias(k, r.shape)
        n_key += int((past & key).sum())
        if (past & ~key).any():
            others[k] = int((past & ~key).sum())
            n_other += others[k]
            n_weight += 0 if k in zero_init else others[k]
        if past.any() and d[past].max() > far:
            far = float(d[past].max())
            far_allow = float(np.broadcast_to(allow[k], d.shape)[past][
                np.argmax(d[past])])
    log(f"[pretrain] {what}: card vs CPU past Adam's allowance "
        f"{err[0]:.3e} of the tensor's max (worst {err[1]}), CPU vs CPU "
        f"reordered {spread[0]:.3e} (worst {spread[1]}), tol {tol:.3e}; "
        f"elements past tol that rely on the allowance (2 R lr a step, R "
        f"the runs' gradient disagreement; 2 lr = {2 * PRETRAIN_LR:g} at "
        f"most): {n_key} key-bias and {n_other} others (at most "
        f"{ALLOWANCE_CAP}, all in tensors that start at zero) {others}, "
        f"the farthest {far:.3e} apart with an allowance of "
        f"{far_allow:.3e}")
    check(all(np.isfinite(v).all() for v in card.values()),
          f"non-finite {what}")
    check(err[0] <= tol, f"card pretraining disagrees with the CPU plain "
                         f"run: {what}")
    check(n_other <= ALLOWANCE_CAP and n_weight == 0,
          f"{what}: {n_other} elements outside the key biases rely on "
          f"Adam's allowance (at most {ALLOWANCE_CAP}), {n_weight} of them "
          f"in tensors that do not start at zero (none may)")


def phase_pretrain_parity(fa):
    """2 Adam steps of a 2-layer bert_base-width model, card against the
    CPU plain path, on the flash and the dense route."""
    rng = np.random.RandomState(5)
    batch = list(synth_batch(rng, PT_PARITY_BATCH, SEQ, VOCAB, MASKED))
    padded = batch[2].copy()
    for i, n in enumerate((SEQ, 100, 77, 64)[:PT_PARITY_BATCH]):
        padded[i, n:] = 0.0
    cpu_net = _bert(PT_PARITY_LAYERS, "cpu")
    cpu_net.initialize(generator=torch.Generator().manual_seed(1))
    state = {k: v.clone() for k, v in cpu_net.state_dict().items()}
    zero_init = {k for k, v in state.items() if not v.any()}
    perm = np.roll(np.arange(PT_PARITY_BATCH), 1)

    def run(device, valid, order):
        net = _bert(PT_PARITY_LAYERS, device)
        net.load_state_dict({k: v.to(device) for k, v in state.items()})
        arrays = [a if a is None else a[order] for a in
                  batch[:2] + [valid] + batch[3:]]
        tensors = [None if a is None else torch.from_numpy(a).to(device)
                   for a in arrays]
        return _pretrain(net, tensors, PT_PARITY_STEPS)

    for route, valid in (("flash", None), ("dense", padded)):
        t0 = time.perf_counter()
        ref = run("cpu", valid, np.arange(PT_PARITY_BATCH))
        again = run("cpu", valid, perm)
        cpu_s = time.perf_counter() - t0
        with no_plain_attention_on_cuda(fa):
            fa.flash_attention.launches = 0
            fa.flash_attention.backward_calls = 0
            card = run("cuda", valid, np.arange(PT_PARITY_BATCH))
            torch.cuda.synchronize()
            launches = fa.flash_attention.launches
            calls = fa.flash_attention.backward_calls
        want = PT_PARITY_LAYERS * PT_PARITY_STEPS if route == "flash" else 0
        log(f"[pretrain] parity, {route} route: {PT_PARITY_LAYERS}-layer "
            f"bert_base width, batch {PT_PARITY_BATCH}, {PT_PARITY_STEPS} "
            f"Adam steps; 2 CPU plain runs in {cpu_s:.1f} s; card: "
            f"{launches} flash launches, {calls} backward calls (want "
            f"{want} each)")
        check(launches == want and calls == want,
              f"{route} route: {launches} flash launches and {calls} "
              f"backward calls in {PT_PARITY_STEPS} steps (want {want})")
        for i in range(PT_PARITY_STEPS):
            spread = abs(again[0][i] - ref[0][i]) / abs(ref[0][i])
            err = abs(card[0][i] - ref[0][i]) / abs(ref[0][i])
            tol = max(1e-4, 2 * spread)
            log(f"[pretrain] {route}: loss of step {i + 1}: card "
                f"{card[0][i]:.6f}, CPU {ref[0][i]:.6f}, relative "
                f"{err:.3e}, CPU reordered {spread:.3e}, tol {tol:.3e}")
            check(math.isfinite(card[0][i]) and err <= tol,
                  f"{route}: loss of step {i + 1} disagrees")
        for i in range(PT_PARITY_STEPS):
            spread, spread_at = _rel(again[1][i], ref[1][i])
            grad_tol = max(1e-4, 2 * spread)
            err, err_at = _rel(card[1][i], ref[1][i])
            log(f"[pretrain] {route}: step-{i + 1} gradients: card vs CPU "
                f"{err:.3e} of the tensor's max (worst {err_at}), CPU vs "
                f"CPU reordered {spread:.3e} (worst {spread_at}), tol "
                f"{grad_tol:.3e}")
            check(all(np.isfinite(v).all() for v in card[1][i].values()),
                  f"{route}: non-finite step-{i + 1} gradients")
            check(err <= grad_tol, f"{route}: step-{i + 1} gradients "
                                   f"disagree")
        _adam_param_check(f"{route}: parameters after step "
                          f"{PT_PARITY_STEPS}", card[2], ref[2], again[2],
                          (card[1], ref[1], again[1]), zero_init)


def phase_pretrain(fa, card, amp_on=False):
    """BERT-base pretraining at full width and depth, batch 32, on tensors;
    returns (flash launches, backward calls, step ms, peak bytes).
    ``amp_on`` (phase 17): the same under ``amp.init()`` with
    ``init_trainer`` and ``scale_loss``, every flash launch on bf16
    q, k, v, and no dense-route steps after."""
    from mxnet_tpu_torch import gluon, telemetry
    from mxnet_tpu_torch.contrib import amp
    tag, precision = ("[amp_pretrain]", "AMP bf16") if amp_on \
        else ("[pretrain]", "fp32")
    net = _bert(PT_LAYERS, None)                     # the default: the GPU
    check(next(net.parameters()).is_cuda, "model did not land on cuda")
    net.initialize(generator=torch.Generator(
        device=next(net.parameters()).device).manual_seed(0))
    n_params = sum(p.numel() for p in net.parameters())
    rng = np.random.RandomState(6)
    arrays = synth_batch(rng, PT_BATCH, SEQ, VOCAB, MASKED)
    tok, seg, valid, pos, mlm_y, nsp_y = (torch.from_numpy(a).cuda()
                                          for a in arrays)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": PRETRAIN_LR})
    if amp_on:
        amp.init()
        amp.init_trainer(trainer)
    step = _pretrain_step_fn(net, (tok, seg, None, pos, mlm_y, nsp_y),
                             trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    telemetry.enable()
    telemetry.reset()
    with no_plain_attention_on_cuda(fa), kernel_dtypes(fa) as seen:
        fa.flash_attention.launches = 0          # the main path starts
        fa.flash_attention.backward_calls = 0
        t0 = time.perf_counter()
        losses = [step() for _ in range(PT_WARM)]
        if amp_on:
            gc.collect()             # as in phase 9: not in a timed step
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PT_TIMED):
            losses.append(step())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = fa.flash_attention.launches   # the main path ends
        calls = fa.flash_attention.backward_calls
    snap = telemetry.snapshot()
    telemetry.disable()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(l) for l in losses]
    steps = PT_WARM + PT_TIMED
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == PT_LAYERS * steps and calls == PT_LAYERS * steps,
          f"{launches} flash launches and {calls} backward calls in {steps} "
          f"steps (want {PT_LAYERS} each a step)")
    want = torch.bfloat16 if amp_on else torch.float32
    check(set(seen) == {want}, f"flash launched on {set(seen)} (want {want})")
    step_ms = (t2 - t1) * 1e3 / PT_TIMED
    upd = snap["spans"].get("trainer.update", {"calls": 1, "total_ms": 0.0})
    log(f"{tag} bert_base ({n_params} parameters) batch {PT_BATCH} x "
        f"T {SEQ}, {MASKED} masked, Adam lr {PRETRAIN_LR:g}, {precision} "
        f"(TF32 off), flash route: {PT_WARM} warm steps "
        f"{(t1 - t0) * 1e3:.1f} ms, "
        f"{PT_TIMED} timed steps {step_ms:.3f} ms each, "
        f"{PT_BATCH * 1e3 / step_ms:.2f} sequences/s, "
        f"{PT_BATCH * SEQ * 1e3 / step_ms:.1f} tokens/s; peak device memory "
        f"{peak / 2**30:.3f} GiB; {launches} flash launches and {calls} "
        f"backward calls ({PT_LAYERS} each a step); trainer.update "
        f"{upd['total_ms'] / max(upd['calls'], 1):.3f} ms host per step; "
        f"on {card}")
    log(f"{tag} loss per step: {[round(l, 4) for l in losses]}")
    try:
        profile_pretrain_step(fa, step, step_ms)
    finally:
        amp.deinit()
    if amp_on:
        return launches, calls, step_ms, peak

    # the dense route: the same function with the bench's all-ones mask
    dense = _pretrain_step_fn(net, (tok, seg, valid, pos, mlm_y, nsp_y),
                              trainer)
    fa.flash_attention.launches = 0
    with no_plain_attention_on_cuda(fa):
        dense_losses = [float(dense())]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PT_DENSE):
            dense_losses.append(float(dense()))
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) * 1e3 / PT_DENSE
    check(fa.flash_attention.launches == 0,
          "the dense route launched the flash kernel")
    check(all(math.isfinite(l) for l in dense_losses),
          f"dense losses {dense_losses}")
    log(f"[pretrain] dense route (all-ones valid_mask): {PT_DENSE} steps "
        f"{dense_ms:.3f} ms each ({PT_BATCH * 1e3 / dense_ms:.2f} "
        f"sequences/s; one warm step first) against the flash route's "
        f"{step_ms:.3f} ms; on {card}")
    return launches, calls, step_ms, peak


def profile_pretrain_step(fa, step, step_ms, top=12):
    """One pretraining step with CUDA events around each call of the
    attention backward (``_attention_backward``), for its device time; then
    device time by kernel over another step (CUPTI through torch.profiler):
    the top kernels, the flash forward's and the grouped Adam update's
    (its ``_foreach`` kernels) shares, and the idle share."""
    from torch.autograd import DeviceType
    real, spans = fa._attention_backward, []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        spans.append((start, end))
        return out

    fa._attention_backward = timed
    try:
        step()
        torch.cuda.synchronize()
    finally:
        fa._attention_backward = real
    bwd_ms = sum(a.elapsed_time(b) for a, b in spans)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        log(f"[profile] pretrain step: {step_ms:.3f} ms wall; attention "
            f"backward {bwd_ms:.3f} ms in {len(spans)} calls (CUDA events); "
            f"device time by kernel not measured (no CUDA events in the "
            f"trace)")
        return
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "fa_forward" in e.key) / 1e3
    adam_ms = sum(e.self_device_time_total for e in kernels
                  if "multi_tensor_apply" in e.key) / 1e3
    log(f"[profile] pretrain step batch {PT_BATCH}: {step_ms:.3f} ms wall "
        f"(mean of {PT_TIMED}), device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / step_ms:.3f}, {len(kernels)} kernels, "
        f"{sum(e.count for e in kernels)} launches; attention backward "
        f"{bwd_ms:.3f} ms in {len(spans)} calls (CUDA events, "
        f"{bwd_ms / busy_ms:.3f} of busy), flash forward kernel "
        f"{flash_ms:.3f} ms ({flash_ms / busy_ms:.3f}), Adam _foreach "
        f"kernels {adam_ms:.3f} ms ({adam_ms / busy_ms:.3f}); "
        f"{_kernel_share(kernels, busy_ms)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def _held(case, got, want, what):
    """``test_utils.compare``, its failure a failed check."""
    from mxnet_tpu_torch.test_utils import compare
    try:
        return compare(case, got, want, what)
    except AssertionError as e:
        check(False, f"[nd] {what} disagrees with the CPU: {e}")


def _moments_ok(s, mean, var):
    """Mean and variance within 5 standard errors (the variance's from the
    sample's fourth moment)."""
    s = s.astype(np.float64).reshape(-1)
    m4 = ((s - s.mean()) ** 4).mean()
    return (abs(s.mean() - mean) <= 5 * math.sqrt(var / s.size) and
            abs(s.var() - var) <= 5 * math.sqrt(max(m4 - s.var() ** 2,
                                                    1e-30) / s.size))


def phase_nd(fa, bs, card):
    """Phase 12: every op of the table on the card against the CPU (the
    cases of ``mxnet_tpu_torch/test_utils.py``), the samplers by moments
    and stream, then ``nd.contrib.flash_attention`` and training
    ``nd.BatchNorm`` through the table, each adding exactly one launch of
    its kernel; returns (flash launches, bn-stats launches) of those
    calls."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.test_utils import (OP_CASES, RANDOM_CASES,
                                            UPDATE_OPS, make_inputs,
                                            run_case)
    gpu = mx.gpu(0)
    t0 = time.perf_counter()
    ran, compared, worst = set(), 0, (0.0, "")
    for case in OP_CASES:
        got, ggot, where = run_case(mx.nd, mx.autograd, case, gpu)
        want, gwant, _ = run_case(mx.nd, mx.autograd, case, mx.cpu())
        check(all(c == gpu for c in where),
              f"[nd] {case.name}: results on {where}, not all on the card")
        err = _held(case, got, want, f"{case.name} {case.attrs} output")
        if case.grad:
            err = max(err, _held(case, ggot, gwant,
                                 f"{case.name} {case.attrs} gradient"))
        if not case.exact and case.dtype == "float32":
            worst = max(worst, (err, case.name))
        ran.add(case.name)
        compared += 1
    for case in UPDATE_OPS:
        arrays = make_inputs(case)
        results = []
        for ctx in (gpu, mx.cpu()):
            xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
            out = getattr(mx.nd, case.name)(*xs, out=xs[0], **case.attrs)
            check(out is xs[0] and all(x.context == ctx for x in xs),
                  f"[nd] {case.name} did not write its inputs in place")
            results.append([x.asnumpy().astype(np.float64) for x in xs])
        _held(case, *results, f"{case.name} written inputs")
        ran.add(case.name)
        compared += 1
    n = 100_000
    for name, inputs, attrs, mean, var in RANDOM_CASES:
        def draw(seed):
            mx.random.seed(seed)
            xs = [mx.nd.array(a, ctx=gpu) for a in inputs]
            return getattr(mx.nd, name)(*xs, ctx=gpu, shape=(n,), **attrs)
        a = draw(7)
        check(a.context == gpu, f"[nd] {name} drew on {a.context}")
        check(np.array_equal(a.asnumpy(), draw(7).asnumpy()),
              f"[nd] {name}: the same seed gave another stream")
        check(_moments_ok(a.asnumpy(), mean, var),
              f"[nd] {name}: moments off ({a.asnumpy().mean()}, "
              f"{a.asnumpy().var()} against {mean}, {var})")
        ran.add(name)
    mx.random.seed(7)
    perm = mx.nd.random.shuffle(mx.nd.arange(n, ctx=gpu))
    mx.random.seed(7)
    again = mx.nd.random.shuffle(mx.nd.arange(n, ctx=gpu))
    check(perm.context == gpu and np.array_equal(
        np.sort(perm.asnumpy()), np.arange(n)) and np.array_equal(
        perm.asnumpy(), again.asnumpy()), "[nd] shuffle is no seeded "
        "permutation on the card")
    ran.add("_shuffle")
    torch.cuda.synchronize()
    not_run = sorted(set(registry.list_ops()) - ran)
    log(f"[nd] {len(ran)} of {len(registry.list_ops())} ops of the table "
        f"({len(registry.all_names())} names) ran on the card: {compared} "
        f"cases held against the CPU at fp32 rtol 1e-5/atol 1e-6 (fp16, "
        f"bf16 1e-2; integer, index and shape outputs exact), worst fp32 "
        f"{worst[0]:.3e} ({worst[1]}); {len(RANDOM_CASES)} samplers by "
        f"moments (n {n}, 5 standard errors) and seeded stream, shuffle as "
        f"a seeded permutation; every result on the card; "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[nd] not run: {not_run or 'none'}")
    check(not not_run, f"[nd] ops of the table not run: {not_run}")

    rng = np.random.RandomState(12)
    q, k, v = (mx.nd.array(rng.randn(*SLICE_QKV), ctx=gpu) for _ in range(3))
    with no_plain_attention_on_cuda(fa):
        fa.flash_attention.launches = 0
        out = mx.nd.contrib.flash_attention(q, k, v, causal=False)
        out.wait_to_read()
        flash = fa.flash_attention.launches
    ref = fa._reference(q.data, k.data, v.data, False,
                        1.0 / math.sqrt(SLICE_QKV[-1]))
    err = (out.data - ref).abs().max().item()
    check(flash == 1, f"[nd] contrib.flash_attention: {flash} launches")
    check(out.context == gpu and math.isfinite(err) and err <= 1e-4,
          f"[nd] contrib.flash_attention disagrees with the plain version: "
          f"{err}")
    shape = RESNET50_BN[1]
    args = [rng.randn(*shape).astype("float32") * 0.5 + 0.2,
            rng.uniform(0.5, 2, shape[1]), rng.randn(shape[1]),
            np.zeros(shape[1]), np.ones(shape[1])]
    results = []
    for ctx in (gpu, mx.cpu()):
        xs = [mx.nd.array(a, ctx=ctx) for a in args]
        with no_plain_stats_on_cuda(bs):
            bs.bn_stats.launches = 0
            with mx.autograd.record():
                y = mx.nd.BatchNorm(*xs, fix_gamma=False)
            y.wait_to_read()
            launched = bs.bn_stats.launches
        results.append((launched, [t.asnumpy() for t in (y, xs[3], xs[4])]))
    bn = results[0][0]
    bn_err = max(float(np.abs(a - b).max())
                 for a, b in zip(results[0][1], results[1][1]))
    check(bn == 1, f"[nd] BatchNorm (training): {bn} bn-stats launches")
    check(bn_err <= 1e-4, f"[nd] BatchNorm (training) disagrees with the "
                          f"CPU plain path: {bn_err}")
    a, b = (mx.nd.array(rng.randn(8, 8), ctx=gpu) for _ in range(2))
    dispatch = {}
    for what, fn in (("nd.elemwise_add", lambda: mx.nd.elemwise_add(a, b)),
                     ("a + b (NDArray)", lambda: a + b),
                     ("torch.add", lambda: torch.add(a.data, b.data))):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        dispatch[what] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    log("[nd] host dispatch per call on (8, 8) fp32, 2000 calls: " +
        ", ".join(f"{k} {v:.2f} us" for k, v in dispatch.items()))
    log(f"[nd] nd.contrib.flash_attention {SLICE_QKV} fp32: {flash} kernel "
        f"launch, max_abs_err {err:.3e} against the plain version (tol "
        f"1e-4); nd.BatchNorm (training) {shape} fp32: {bn} bn-stats "
        f"launch, output and written-back moving statistics within "
        f"{bn_err:.3e} of the CPU plain path (tol 1e-4)")
    return flash, bn


def _nd_pretrain_run(fa, steps, keep, timed=0):
    """``example/bert/pretrain.py``'s loop through NDArrays at phase 11's
    configuration: ``keep`` returns (losses, every step's gradients and the
    final parameters, on the card); ``timed`` then times that many steps
    more and returns (step ms, peak bytes, losses)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    ctx = mx.gpu(0)
    net = _bert(PT_LAYERS, None)
    net.initialize(ctx=ctx, generator=torch.Generator(
        device="cuda").manual_seed(0))
    rng = np.random.RandomState(6)
    tok, seg, _, pos, mlm_y, nsp_y = synth_batch(rng, PT_BATCH, SEQ, VOCAB,
                                                 MASKED)
    tok, seg, pos = (mx.nd.array(a, dtype="int32", ctx=ctx)
                     for a in (tok, seg, pos))
    mlm_y, nsp_y = mx.nd.array(mlm_y, ctx=ctx), mx.nd.array(nsp_y, ctx=ctx)
    params = net.collect_params()
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "adam", {"learning_rate": PRETRAIN_LR})
    grads = []

    def step(on_grads=None):
        with mx.autograd.record():
            _, _, mlm, nsp = net(tok, seg, None, pos)
            loss = sce(mlm.reshape((-1, VOCAB)),
                       mlm_y.reshape((-1,))).mean() + sce(nsp, nsp_y).mean()
        loss.backward()
        if on_grads is not None:
            on_grads()
        trainer.step(PT_BATCH)
        return loss

    def grab():
        grads.append({k: p.grad().clone() for k, p in params.items()
                      if p.grad_req != "null"})

    if not keep:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses = [step(grab if keep else None) for _ in range(steps)]
    check(all(isinstance(l, mx.nd.NDArray) for l in losses),
          "[nd_pretrain] the loss is not an NDArray")
    losses[-1].wait_to_read()
    losses = [float(l.asscalar()) for l in losses]
    if keep:
        return losses, grads, {k: p.data().detach().clone()
                               for k, p in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        loss = step()
    loss.wait_to_read()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    return step_ms, torch.cuda.max_memory_allocated(), \
        losses + [float(loss.asscalar())]


def _nd_pretrain_parity(fa, steps=3):
    """Phase 13's first part: ``steps`` steps through NDArrays held to two
    runs of phase 11's tensor path from the same weights."""
    from mxnet_tpu_torch import gluon

    def tensor_run():
        net = _bert(PT_LAYERS, None)
        net.initialize(generator=torch.Generator(
            device="cuda").manual_seed(0))
        rng = np.random.RandomState(6)
        arrays = synth_batch(rng, PT_BATCH, SEQ, VOCAB, MASKED)
        tok, seg, _, pos, mlm_y, nsp_y = (torch.from_numpy(a).cuda()
                                          for a in arrays)
        params = net.collect_params()
        trainer = gluon.Trainer(params, "adam",
                                {"learning_rate": PRETRAIN_LR})
        grads = []
        step = _pretrain_step_fn(
            net, (tok, seg, None, pos, mlm_y, nsp_y), trainer,
            lambda: grads.append({k: p.grad().clone()
                                  for k, p in params.items()
                                  if p.grad_req != "null"}))
        losses = [float(step()) for _ in range(steps)]
        return losses, grads, {k: p.data().detach().clone()
                               for k, p in params.items()}

    # the token-type embedding's gradient (2 rows, 4096 ids) is summed in
    # no fixed order by torch's default CUDA kernel, so two runs of the
    # tensor path differ from step 1 (2e-7 on an H100); with torch's
    # deterministic algorithms they agree bit for bit, and the NDArray path
    # is held to that
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        ref, again = tensor_run(), tensor_run()
        with no_plain_attention_on_cuda(fa):
            nd_run = _nd_pretrain_run(fa, steps, keep=True)
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    worst = (0.0, "")
    for i in range(steps):
        spread = abs(again[0][i] - ref[0][i])
        d = abs(nd_run[0][i] - ref[0][i])
        check(math.isfinite(nd_run[0][i]) and
              d <= spread + 1e-6 * abs(ref[0][i]),
              f"[nd_pretrain] loss of step {i + 1}: {nd_run[0][i]} against "
              f"{ref[0][i]} (tensor path's own spread {spread})")
    pairs = [(f"step-{i + 1} gradient", nd_run[1][i], ref[1][i],
              again[1][i]) for i in range(steps)]
    pairs.append(("parameter", nd_run[2], ref[2], again[2]))
    for what, got, want, twin in pairs:
        check(sorted(got) == sorted(want), f"[nd_pretrain] {what} names")
        for k, r in want.items():
            scale = r.abs().max().item()
            d = (got[k] - r).abs().max().item()
            spread = (twin[k] - r).abs().max().item()
            check(math.isfinite(d) and d <= spread + 1e-6 * scale,
                  f"[nd_pretrain] {what} {k}: {d} from the tensor path "
                  f"(its own spread {spread}, 1e-6 of the max "
                  f"{1e-6 * scale})")
            worst = max(worst, (d / max(scale, 1e-30), f"{what} {k}"))
    log(f"[nd_pretrain] bert_base through NDArrays, {steps} Adam steps "
        f"from the weights of phase 11's tensor path: losses "
        f"{[round(l, 6) for l in nd_run[0]]} against "
        f"{[round(l, 6) for l in ref[0]]}; largest difference of a loss, "
        f"gradient or parameter {worst[0]:.3e} of its tensor's max "
        f"({worst[1] if worst[0] else 'none'}); the tensor path against "
        f"itself {max(abs(a - b) for a, b in zip(again[0], ref[0])):.3e} "
        f"(losses; torch's deterministic algorithms on for these runs)")


def phase_nd_pretrain(fa, card, tensor_ms, tensor_peak):
    """Phase 13: BERT-base pretraining at phase 11's configuration written
    as ``example/bert/pretrain.py`` writes it, through NDArrays: held to
    the tensor path (:func:`_nd_pretrain_parity`), then 3 warm and 10
    timed steps; returns (flash launches, backward calls) over those 13."""
    torch.cuda.empty_cache()
    _nd_pretrain_parity(fa)
    # the parity runs' models and Adam states are freed when the function
    # returns: a gluon Parameter holds its block's tensor weakly
    left = torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    with no_plain_attention_on_cuda(fa):
        fa.flash_attention.launches = 0          # the main path starts
        fa.flash_attention.backward_calls = 0
        step_ms, peak, losses = _nd_pretrain_run(fa, PT_WARM, keep=False,
                                                 timed=PT_TIMED)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches   # the main path ends
        calls = fa.flash_attention.backward_calls
    total = PT_WARM + PT_TIMED
    check(launches == PT_LAYERS * total and calls == PT_LAYERS * total,
          f"[nd_pretrain] {launches} flash launches and {calls} backward "
          f"calls in {total} steps (want {PT_LAYERS} each a step)")
    check(all(math.isfinite(l) for l in losses) and losses[-1] < losses[0],
          f"[nd_pretrain] losses {losses}")
    log(f"[nd_pretrain] bert_base batch {PT_BATCH} x T {SEQ} through "
        f"NDArrays (pretrain.py's loop, no mask: the flash route): "
        f"{PT_WARM} warm and {PT_TIMED} timed steps, {step_ms:.3f} ms a step "
        f"({PT_BATCH * 1e3 / step_ms:.2f} sequences/s), peak device memory "
        f"{peak / 2**30:.3f} GiB; phase 11's tensor path {tensor_ms:.3f} ms "
        f"({PT_BATCH * 1e3 / tensor_ms:.2f} sequences/s), "
        f"{tensor_peak / 2**30:.3f} GiB; {launches} flash launches and "
        f"{calls} backward calls ({PT_LAYERS} each a step); "
        f"{left / 2**30:.3f} GiB still allocated after the parity runs, "
        f"no manual collection; on {card}")
    # the NDArray loop's one extra buffer: reshape's copy of the masked-LM
    # logits (values, not views)
    extra = PT_BATCH * MASKED * VOCAB * 4
    check(peak <= tensor_peak + extra,
          f"[nd_pretrain] peak {peak / 2**30:.3f} GiB above phase 11's "
          f"{tensor_peak / 2**30:.3f} GiB plus the logits' copy "
          f"{extra / 2**30:.3f} GiB")
    return launches, calls


MODULE_UNITS, MODULE_FILTERS = [3, 4, 6, 3], [64, 256, 512, 1024, 2048]


def _module(ctx, sym, batch, params=None, initializer=None):
    """A bound ``Module`` on ``ctx`` with ``params`` (numpy, by name) or an
    initializer, and phase 8's SGD through kvstore ``'local'``."""
    import mxnet_tpu_torch as mx
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch,) + IMAGE)],
             label_shapes=[("softmax_label", (batch,))])
    if params is not None:
        mod.set_params(*params)
    else:
        mod.init_params(initializer)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(TRAIN_OPT))
    return mod


def _module_steps(mod, ctx, x, y, steps):
    """``steps`` of ``forward_backward`` + ``update``; (per-sample losses
    of each step, the step-1 gradients, final parameters and auxiliary
    states), on the host.  The loss is the cross entropy of the
    ``SoftmaxOutput`` probabilities."""
    import mxnet_tpu_torch as mx
    losses, grads = [], None
    for step in range(steps):
        batch = mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                [mx.nd.array(y, ctx=ctx)])
        mod.forward_backward(batch)
        prob = mod.get_outputs()[0].asnumpy()
        losses.append(-np.log(prob[np.arange(len(y)), y.astype(int)]))
        if step == 0:
            grads = {k: v.asnumpy().copy()
                     for k, v in mod._exec.grad_dict.items()}
        mod.update()
    arg, aux = mod.get_params()
    return losses, grads, {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


def phase_module_parity(bs):
    """Phase 14: the symbolic ResNet-50 v1 through ``Module`` at batch 8,
    2 SGD steps on the card against the CPU plain path (phase 8's
    criterion), 53 bn-stats launches per forward, and the graph's JSON
    round trip bit for bit on the card."""
    import mxnet_tpu_torch as mx
    sym = resnet_v1_symbol(mx.sym, MODULE_UNITS, MODULE_FILTERS, 1000)
    rng = np.random.RandomState(7)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(PARITY_BATCH,) + IMAGE)
    args = {n: _seeded(n, s, rng).astype("float32")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: _seeded(n.replace("moving_", "running_"), s, rng)
            .astype("float32")
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    x = rng.randn(PARITY_BATCH, *IMAGE).astype("float32")
    y = rng.randint(0, 1000, PARITY_BATCH).astype("float32")
    perm = np.roll(np.arange(PARITY_BATCH), 3)

    def cpu_run(order):
        mod = _module(mx.cpu(), sym, PARITY_BATCH, (args, auxs))
        run = _module_steps(mod, mx.cpu(), x[order], y[order], PARITY_STEPS)
        return [l[np.argsort(order)] for l in run[0]], run[1], run[2]

    t0 = time.perf_counter()
    ref = cpu_run(np.arange(PARITY_BATCH))
    again = cpu_run(perm)
    cpu_s = time.perf_counter() - t0
    card_ctx = mx.gpu(0)
    with no_plain_stats_on_cuda(bs):
        mod = _module(card_ctx, sym, PARITY_BATCH, (args, auxs))
        bs.bn_stats.launches = 0                 # the parity path starts
        card = _module_steps(mod, card_ctx, x, y, PARITY_STEPS)
        torch.cuda.synchronize()
        launches = bs.bn_stats.launches          # the parity path ends
    check(launches == BN_PER_FORWARD * PARITY_STEPS,
          f"[module] {launches} bn-stats launches for {PARITY_STEPS} "
          f"training forwards (want {BN_PER_FORWARD} each)")
    log(f"[module] parity: symbolic resnet50_v1 ({len(sym._topo())} nodes, "
        f"{len(args)} parameters, {len(auxs)} auxiliary states), 2 CPU "
        f"plain runs of {PARITY_STEPS} Module steps at batch {PARITY_BATCH} "
        f"in {cpu_s:.1f} s; card: {launches} bn-stats launches "
        f"({BN_PER_FORWARD} per forward), none of the plain version")
    quantities = [(f"loss of step {i + 1}", lambda r, i=i: {"l": r[0][i]})
                  for i in range(PARITY_STEPS)]
    quantities += [("step-1 gradients", lambda r: r[1]),
                   (f"parameters and auxiliary states after step "
                    f"{PARITY_STEPS}", lambda r: r[2])]
    for what, pick in quantities:
        spread, spread_at = _rel(pick(again), pick(ref))
        tol = max(1e-4, 2 * spread)
        err, err_at = _rel(pick(card), pick(ref))
        log(f"[module] {what}: card vs CPU {err:.3e} of the tensor's max "
            f"(worst {err_at}), CPU vs CPU reordered {spread:.3e} (worst "
            f"{spread_at}), tol {tol:.3e}")
        check(all(np.isfinite(v).all() for v in pick(card).values()),
              f"[module] non-finite {what}")
        check(err <= tol, f"[module] card training disagrees with the CPU "
                          f"plain run: {what}")
    log(f"[module] losses, card: {[float(l.mean()) for l in card[0]]}, "
        f"CPU: {[float(l.mean()) for l in ref[0]]}")

    # the graph's JSON, loaded back, gives the same outputs bit for bit
    again_sym = mx.sym.load_json(sym.tojson())
    check(again_sym.tojson() == sym.tojson(), "[module] JSON round trip "
                                              "changed the graph")
    arg_p, aux_p = mod.get_params()
    feed = {"data": mx.nd.array(x, ctx=card_ctx),
            "softmax_label": mx.nd.array(y, ctx=card_ctx)}
    outs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for s in (sym, again_sym):
            ex = s.bind(card_ctx, args={**arg_p, **feed},
                        aux_states={k: v.copy() for k, v in aux_p.items()},
                        grad_req="null")
            outs.append(ex.forward(is_train=True)[0].asnumpy())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(np.array_equal(outs[0], outs[1]),
          "[module] the JSON-loaded graph's outputs differ")
    log(f"[module] tojson -> load_json: the same graph, training-mode "
        f"outputs on the card equal bit for bit ({outs[0].shape})")


def phase_module(bs, card, gluon_ms, gluon_peak):
    """Phase 15: ``Module.fit`` on the symbolic ResNet-50 v1 at batch 32
    over 13 seeded batches (3 warm, 10 timed), then a ``[profile]`` of
    one step; returns the bn-stats launches of the fit."""
    import mxnet_tpu_torch as mx
    sym = resnet_v1_symbol(mx.sym, MODULE_UNITS, MODULE_FILTERS, 1000)
    steps = WARM_STEPS + TIMED_STEPS
    rng = np.random.RandomState(8)
    x = rng.randn(steps * TRAIN_BATCH, *IMAGE).astype("float32")
    y = rng.randint(0, 1000, steps * TRAIN_BATCH).astype("float32")
    ctx = mx.gpu(0)
    mx.random.seed(8)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = {}

    def clock(param):
        if param.nbatch in (WARM_STEPS - 1, steps - 1):
            if param.nbatch == WARM_STEPS - 1:
                gc.collect()               # as in phase 9: not in a timed step
            torch.cuda.synchronize()
            marks[param.nbatch] = time.perf_counter()

    mod = mx.mod.Module(sym, context=ctx)
    metric = mx.metric.create(["acc", "ce"])
    # fit's own log (the Speedometer's lines, the epoch's metric) to stdout
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[module] fit: %(message)s"))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        with no_plain_stats_on_cuda(bs):
            bs.bn_stats.launches = 0             # the Module path starts
            mod.fit(mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH),
                    num_epoch=1, eval_metric=metric, kvstore="local",
                    initializer=mx.init.Xavier(rnd_type="gaussian",
                                               factor_type="in",
                                               magnitude=2),
                    optimizer="sgd", optimizer_params=dict(TRAIN_OPT),
                    batch_end_callback=[
                        mx.callback.Speedometer(TRAIN_BATCH, 5), clock])
            torch.cuda.synchronize()
            launches = bs.bn_stats.launches      # the Module path ends
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    peak = torch.cuda.max_memory_allocated()
    step_ms = (marks[steps - 1] - marks[WARM_STEPS - 1]) * 1e3 / TIMED_STEPS
    names, values = metric.get_global()
    check(launches == BN_PER_FORWARD * steps,
          f"[module] {launches} bn-stats launches in {steps} fit steps "
          f"(want {BN_PER_FORWARD} each)")
    check(all(math.isfinite(v) for v in values), f"[module] {values}")
    check(all(p.context == ctx and np.isfinite(p.asnumpy()).all()
              for p in mod.get_params()[0].values()),
          "[module] parameters off the card or not finite")
    log(f"[module] Module.fit symbolic resnet50_v1 batch {TRAIN_BATCH} fp32 "
        f"(TF32 off, kvstore local, NDArrayIter, acc+ce metric, "
        f"Speedometer): {TIMED_STEPS} timed steps after {WARM_STEPS} warm, "
        f"{step_ms:.3f} ms each, {TRAIN_BATCH * 1e3 / step_ms:.2f} images/s; "
        f"peak device memory {peak / 2**30:.3f} GiB; phase 9's gluon step "
        f"{gluon_ms:.3f} ms ({TRAIN_BATCH * 1e3 / gluon_ms:.2f} images/s), "
        f"{gluon_peak / 2**30:.3f} GiB; {launches} bn-stats launches "
        f"({BN_PER_FORWARD} per step); train metric "
        f"{dict(zip(names, values))}; on {card}")
    profile_module_step(mod, ctx, x[:TRAIN_BATCH], y[:TRAIN_BATCH], step_ms)
    return launches


def profile_module_step(mod, ctx, x, y, step_ms, top=12):
    """One ``Module`` step in the parts ``fit`` runs, host ms of each
    (the executor's walk, backward, the kvstore update, the metric, whose
    ``asnumpy`` waits for the device), then device time by kernel over a
    second step (torch.profiler)."""
    import mxnet_tpu_torch as mx
    from torch.autograd import DeviceType
    metric = mx.metric.create(["acc", "ce"])
    batch = mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                            [mx.nd.array(y, ctx=ctx)])

    def step():
        t = [time.perf_counter()]
        mod.forward(batch, is_train=True)
        t.append(time.perf_counter())
        mod.backward()
        t.append(time.perf_counter())
        mod.update()
        t.append(time.perf_counter())
        mod.update_metric(metric, batch.label)
        t.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

    step()
    torch.cuda.synchronize()
    host = step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    parts = ", ".join(f"{n} {v:.3f} ms" for n, v in zip(
        ("forward (executor walk)", "backward", "update (kvstore push and "
         "pull)", "metric (waits for the device)"), host))
    if not busy_ms:
        log(f"[profile] module step: host {parts}; device time not "
            f"measured (no CUDA events in the trace)")
        return
    bn_ms = sum(e.self_device_time_total for e in kernels
                if "bn_stats" in e.key) / 1e3
    log(f"[profile] module step batch {TRAIN_BATCH}: {step_ms:.3f} ms wall "
        f"(mean of {TIMED_STEPS} fit steps), device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / step_ms:.3f}, {len(kernels)} kernels, "
        f"{sum(e.count for e in kernels)} launches; bn-stats kernels "
        f"{bn_ms:.3f} ms; host: {parts}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")



# ------------------------------------------------- mixed precision (slice 9)
PT_AMP_STEPS = 3


def layer_dtypes(net):
    """Forward hooks on every module under ``net`` recording (class,
    output dtypes) in call order; returns (the list, the hooks)."""
    trace = []

    def hook(m, args, out):
        outs = out if isinstance(out, (tuple, list)) else [out]
        trace.append((type(m).__name__, tuple(str(o.dtype)[6:] for o in outs
                                              if torch.is_tensor(o))))
    return trace, [m.register_forward_hook(hook) for m in net.modules()
                   if m is not net]


def amp_held(tag, what, card, ref, again, fp32, ulp=2.0 ** -8):
    """Each tensor of ``card`` within twice the CPU AMP run's own noise of
    ``ref`` (L2): the largest of its distance from itself with the batch
    reordered (``again``), from the CPU fp32 run (``fp32``) and one
    rounding of the low-precision type (``ulp`` of its norm: 2^-8 for
    bf16, 2^-11 for fp16).  Low-precision rounding is discontinuous, so
    any change of summation order (the card's cuBLAS/cuDNN against the
    CPU's) draws its rounding noise anew; the fp32 run's distance measures
    that noise's size, and a tensor that reaches the loss through a
    low-precision value (a bias added in bf16) carries at least one such
    rounding in every element."""
    worst, reorder, effect = (0.0, ""), 0.0, 0.0
    for k, r in ref.items():
        n_r = float(np.linalg.norm(r))
        d_again = float(np.linalg.norm(again[k] - r))
        d_fp32 = float(np.linalg.norm(fp32[k] - r))
        noise = max(d_again, d_fp32, ulp * n_r, 1e-30)
        worst = max(worst, (float(np.linalg.norm(card[k] - r)) / noise, k))
        reorder = max(reorder, d_again / max(n_r, 1e-30))
        effect = max(effect, d_fp32 / max(n_r, 1e-30))
    log(f"{tag} {what}: card vs CPU AMP {worst[0]:.3f} of the CPU AMP "
        f"run's own noise (worst {worst[1]}; tol 2); CPU AMP vs reordered "
        f"up to {reorder:.3e}, vs fp32 up to {effect:.3e} of a tensor's "
        f"norm")
    check(all(np.isfinite(v).all() for v in card.values()),
          f"{tag} non-finite {what}")
    check(worst[0] <= 2.0, f"{tag} card disagrees with the CPU AMP run: "
                           f"{what}")


def _past_allowance(run, ref, allow):
    """``run``'s parameters moved towards ``ref``'s by Adam's allowance."""
    return {k: ref[k] + np.sign(v - ref[k]) * np.maximum(
        np.abs(v - ref[k]) - allow[k], 0.0) for k, v in run.items()}


def phase_amp_pretrain_parity(fa):
    """Phase 16: 3 Adam steps of a 2-layer bert_base-width model under AMP
    (``amp.init``, ``init_trainer``, ``scale_loss``), card against CPU:
    the layers' dtypes equal, losses, every step's unscaled gradients and
    the parameters (past Adam's allowance) held by :func:`amp_held`; the
    flash kernel on bf16 q, k, v, one launch and one backward a layer a
    step."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.contrib import amp
    rng = np.random.RandomState(5)
    batch = list(synth_batch(rng, PT_PARITY_BATCH, SEQ, VOCAB, MASKED))
    cpu_net = _bert(PT_PARITY_LAYERS, "cpu")
    cpu_net.initialize(generator=torch.Generator().manual_seed(1))
    state = {k: v.clone() for k, v in cpu_net.state_dict().items()}
    del cpu_net
    perm = np.roll(np.arange(PT_PARITY_BATCH), 1)

    def run(device, order, amp_on):
        net = _bert(PT_PARITY_LAYERS, device)
        net.load_state_dict({k: v.to(device) for k, v in state.items()})
        tensors = [None if a is None else torch.from_numpy(a[order])
                   .to(device) for a in batch[:2] + [None] + batch[3:]]
        params = net.collect_params()
        trainer = gluon.Trainer(params, "adam",
                                {"learning_rate": PRETRAIN_LR})
        grads = []

        def on_grads():
            scale = trainer._amp_loss_scaler.loss_scale if amp_on else 1.0
            grads.append({k: p.grad().float().cpu().numpy() / scale
                          for k, p in params.items()})
        trace, hooks = layer_dtypes(net)
        if amp_on:
            amp.init()
            amp.init_trainer(trainer)
        try:
            step = _pretrain_step_fn(net, tensors, trainer, on_grads)
            losses = [float(step().float().cpu())
                      for _ in range(PT_AMP_STEPS)]
        finally:
            amp.deinit()
            for h in hooks:
                h.remove()
        return ({"l": np.array(losses)}, grads,
                {k: p.data().detach().float().cpu().numpy()
                 for k, p in params.items()}, trace)

    t0 = time.perf_counter()
    ref = run("cpu", np.arange(PT_PARITY_BATCH), True)
    again = run("cpu", perm, True)
    fp32 = run("cpu", np.arange(PT_PARITY_BATCH), False)
    cpu_s = time.perf_counter() - t0
    with no_plain_attention_on_cuda(fa), kernel_dtypes(fa) as seen:
        fa.flash_attention.launches = 0          # the parity path starts
        fa.flash_attention.backward_calls = 0
        card = run("cuda", np.arange(PT_PARITY_BATCH), True)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches   # the parity path ends
        calls = fa.flash_attention.backward_calls
    want = PT_PARITY_LAYERS * PT_AMP_STEPS
    log(f"[amp_pretrain] parity: {PT_PARITY_LAYERS}-layer bert_base width, "
        f"batch {PT_PARITY_BATCH}, {PT_AMP_STEPS} Adam steps under AMP; 3 "
        f"CPU runs (AMP, AMP reordered, fp32) in {cpu_s:.1f} s; card: "
        f"{launches} flash launches on {sorted(map(str, set(seen)))}, "
        f"{calls} backward calls (want {want} each); layer dtypes: "
        f"{len(card[3])} outputs, card == CPU: {card[3] == ref[3]}")
    check(launches == want and calls == want and
          set(seen) == {torch.bfloat16},
          f"[amp_pretrain] {launches} flash launches on {set(seen)} and "
          f"{calls} backward calls (want {want} on bf16)")
    check(card[3] == ref[3] and ("Dense", ("bfloat16",)) in card[3],
          "[amp_pretrain] the card's layer dtypes differ from the CPU's")
    amp_held("[amp_pretrain]", "losses", card[0], ref[0], again[0], fp32[0])
    for i in range(PT_AMP_STEPS):
        amp_held("[amp_pretrain]", f"step-{i + 1} gradients", card[1][i],
                 ref[1][i], again[1][i], fp32[1][i])
    params = [_past_allowance(r[2], ref[2], adam_allowance(
        r[1], ref[1], PRETRAIN_LR)) for r in (card, again)]
    amp_held("[amp_pretrain]", f"parameters after step {PT_AMP_STEPS} past "
             f"Adam's allowance", params[0], ref[2], params[1], fp32[2])
    return launches


def phase_amp_train_parity(bs, path):
    """Phase 18's parity: 2 SGD steps of ResNet-50 v1 at batch 8 under AMP,
    card against CPU (phase 8's quantities, held by :func:`amp_held`),
    the layers' dtypes equal, 53 bn-stats launches a forward on fp32
    inputs."""
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    rng = np.random.RandomState(2)
    x = rng.randn(PARITY_BATCH, *IMAGE).astype("float32")
    y = rng.randint(0, 1000, PARITY_BATCH).astype("float32")
    perm = np.roll(np.arange(PARITY_BATCH), 3)

    def run(device, order, amp_on):
        net = get_model("resnet50_v1", classes=1000, device=device)
        net.load_parameters(str(path))
        trace, hooks = layer_dtypes(net)
        try:
            out = _train(net, torch.from_numpy(x[order]).to(device),
                         torch.from_numpy(y[order]).to(device),
                         PARITY_STEPS, amp_on)
        finally:
            for h in hooks:
                h.remove()
        losses = {f"step {i + 1}": l[np.argsort(order)]
                  for i, l in enumerate(out[0])}
        return losses, out[1], out[2], trace

    t0 = time.perf_counter()
    ref = run("cpu", np.arange(PARITY_BATCH), True)
    again = run("cpu", perm, True)
    fp32 = run("cpu", np.arange(PARITY_BATCH), False)
    cpu_s = time.perf_counter() - t0
    with no_plain_stats_on_cuda(bs), kernel_dtypes(bs) as seen:
        bs.bn_stats.launches = 0                 # the parity path starts
        card = run("cuda", np.arange(PARITY_BATCH), True)
        torch.cuda.synchronize()
        launches = bs.bn_stats.launches          # the parity path ends
    log(f"[amp_train] parity: 3 CPU runs (AMP, AMP reordered, fp32) of "
        f"{PARITY_STEPS} steps at batch {PARITY_BATCH} in {cpu_s:.1f} s; "
        f"card: {launches} bn-stats launches on "
        f"{sorted(map(str, set(seen)))}; layer dtypes: {len(card[3])} "
        f"outputs, card == CPU: {card[3] == ref[3]}")
    check(launches == BN_PER_FORWARD * PARITY_STEPS and
          set(seen) == {torch.float32},
          f"[amp_train] {launches} bn-stats launches on {set(seen)} (want "
          f"{BN_PER_FORWARD} a forward on float32)")
    check(card[3] == ref[3] and ("Conv2D", ("bfloat16",)) in card[3],
          "[amp_train] the card's layer dtypes differ from the CPU's")
    for what, i in (("per-sample losses", 0), ("step-1 gradients", 1),
                    ("parameters and running statistics after step "
                     f"{PARITY_STEPS}", 2)):
        amp_held("[amp_train]", what, card[i], ref[i], again[i], fp32[i])


def phase_fp16_and_symbolic(bs, path, card_name):
    """Phase 19.  (a) ResNet-50 v1 ``cast("float16")`` (BatchNorm stays
    fp32) with ``SGD(multi_precision=True, momentum=0.9)``: 2 steps at
    batch 8, card against CPU (:func:`amp_held`, the fp32 run being phase
    8's), 53 bn-stats launches a forward on fp16 inputs; then
    ``mp_sgd_mom_update`` per parameter on the card against the grouped
    update, bit for bit.  (b) ``amp.convert_model`` of the symbolic
    ResNet-50 v1 through ``Module.forward`` (inference, batch 8), card
    against CPU.  Returns the bn-stats launches of (a)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.ops import optimizer_ops
    from mxnet_tpu_torch.optimizer import aggregate, create
    rng = np.random.RandomState(9)
    x = rng.randn(PARITY_BATCH, *IMAGE).astype("float32")
    y = rng.randint(0, 1000, PARITY_BATCH).astype("float32")
    perm = np.roll(np.arange(PARITY_BATCH), 3)
    opt = dict(TRAIN_OPT, multi_precision=True)

    def run(device, order, half):
        net = get_model("resnet50_v1", classes=1000, device=device)
        net.load_parameters(str(path))
        if half:
            net.cast("float16")
        xs = torch.from_numpy(x[order]).to(device)
        out = _train(net, xs.half() if half else xs,
                     torch.from_numpy(y[order]).to(device), PARITY_STEPS,
                     opt=opt)
        losses = {f"step {i + 1}": l[np.argsort(order)]
                  for i, l in enumerate(out[0])}
        return (losses,) + out[1:] + (net,)

    t0 = time.perf_counter()
    ref = run("cpu", np.arange(PARITY_BATCH), True)
    again = run("cpu", perm, True)
    fp32 = run("cpu", np.arange(PARITY_BATCH), False)
    cpu_s = time.perf_counter() - t0
    with no_plain_stats_on_cuda(bs), kernel_dtypes(bs) as seen:
        bs.bn_stats.launches = 0                 # the fp16 path starts
        card = run("cuda", np.arange(PARITY_BATCH), True)
        torch.cuda.synchronize()
        launches = bs.bn_stats.launches          # the fp16 path ends
    net = card[3]
    dtypes = {str(t.dtype)[6:] for t in net.state_dict().values()}
    log(f"[fp16] resnet50_v1 cast('float16'), SGD multi_precision "
        f"momentum 0.9: 3 CPU runs (fp16, fp16 reordered, fp32) of "
        f"{PARITY_STEPS} steps at batch {PARITY_BATCH} in {cpu_s:.1f} s; "
        f"card: {launches} bn-stats launches on "
        f"{sorted(map(str, set(seen)))}; parameter dtypes {sorted(dtypes)}")
    check(launches == BN_PER_FORWARD * PARITY_STEPS and
          set(seen) == {torch.float16},
          f"[fp16] {launches} bn-stats launches on {set(seen)} (want "
          f"{BN_PER_FORWARD} a forward on float16)")
    for what, i in (("per-sample losses", 0), ("step-1 gradients", 1),
                    ("parameters and running statistics after step "
                     f"{PARITY_STEPS}", 2)):
        amp_held("[fp16]", what, card[i], ref[i], again[i], fp32[i],
                 ulp=2.0 ** -11)

    # mp_sgd_mom_update per parameter against the grouped update, on card
    weights = [p for p in net.parameters() if p.dtype == torch.float16][:8]
    grads = [torch.randn(w.shape, device=w.device).half() for w in weights]
    o = create("sgd", **opt)
    states = [o.create_state_multi_precision(i, w)
              for i, w in enumerate(weights)]
    single = [(w.detach().clone(), s[0].clone(), s[1].clone())
              for w, s in zip(weights, states)]
    grouped = [(w.detach().clone(), (s[0].clone(), s[1].clone()))
               for w, s in zip(weights, states)]
    lr, wd = o._get_lr(0), o._get_wd(0)
    for (w, m32, mom), g in zip(single, grads):
        optimizer_ops.mp_sgd_mom_update(w, g, mom, m32, lr, o.momentum, wd,
                                        1.0 / PARITY_BATCH)
    o.rescale_grad = 1.0 / PARITY_BATCH
    aggregate.update_multi(o, list(range(len(weights))),
                           [w for w, _ in grouped], grads,
                           [s for _, s in grouped])
    torch.cuda.synchronize()
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1][0]) and
               torch.equal(a[2], b[1][1]) for a, b in zip(single, grouped))
    log(f"[fp16] mp_sgd_mom_update on the card for {len(weights)} fp16 "
        f"weights: the grouped multi-precision update equal bit for bit: "
        f"{same}")
    check(same, "[fp16] grouped multi-precision update differs from "
                "mp_sgd_mom_update")

    # (b) convert_model of the symbolic ResNet-50 v1, inference
    sym = resnet_v1_symbol(mx.sym, MODULE_UNITS, MODULE_FILTERS, 1000)
    rng = np.random.RandomState(10)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(PARITY_BATCH,) + IMAGE)
    args = {n: _seeded(n, s, rng).astype("float32")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: _seeded(n.replace("moving_", "running_"), s, rng)
            .astype("float32")
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    xs = rng.randn(PARITY_BATCH, *IMAGE).astype("float32")

    def infer(ctx, converted, order):
        nd_args = {k: mx.nd.array(v, ctx=ctx) for k, v in args.items()}
        nd_aux = {k: mx.nd.array(v, ctx=ctx) for k, v in auxs.items()}
        s, a = sym, nd_args
        if converted:
            s, a, nd_aux = amp.convert_model(sym, nd_args, nd_aux)
        mod = mx.mod.Module(s, context=ctx)
        mod.bind(data_shapes=[("data", (PARITY_BATCH,) + IMAGE)],
                 for_training=False)
        mod.set_params(a, nd_aux)
        mod.forward(mx.io.DataBatch([mx.nd.array(xs[order], ctx=ctx)]),
                    is_train=False)
        out = mod.get_outputs()[0]
        n_cast = sum(1 for n in s._topo() if n.op is not None and
                     n.op.name == "amp_cast")
        lp = sum(1 for v in a.values() if str(v.dtype) == "torch.bfloat16")
        return {"p": out.asnumpy()[np.argsort(order)]}, str(out.dtype), \
            n_cast, lp

    t0 = time.perf_counter()
    ref = infer(mx.cpu(), True, np.arange(PARITY_BATCH))
    again = infer(mx.cpu(), True, perm)
    fp32 = infer(mx.cpu(), False, np.arange(PARITY_BATCH))
    cpu_s = time.perf_counter() - t0
    card = infer(mx.gpu(0), True, np.arange(PARITY_BATCH))
    log(f"[amp_symbol] convert_model(resnet_v1_symbol): {card[2]} amp_cast "
        f"nodes, {card[3]} bf16 parameters; Module.forward inference at "
        f"batch {PARITY_BATCH}, output {card[1]}; 3 CPU runs in "
        f"{cpu_s:.1f} s")
    check(card[1] == "float32" and card[2] > 0 and card[3] > 0,
          "[amp_symbol] the converted model did not run in bf16")
    amp_held("[amp_symbol]", "softmax outputs", card[0], ref[0], again[0],
             fp32[0])
    return launches


# ------------------------------------------------------------ slice 10
def phase_bn_kernel_cl(bs, card):
    """Phase 20: the bn-stats kernel's channels-last entry against its
    plain version at the 53 NHWC BatchNorm inputs' nine geometries of
    ResNet-50 at batch 32, fp32 and fp16 (atol 2e-5, as phase 7), and
    against the NCHW entry on the same data transposed (1e-6, fp32, the
    same pivot element); per geometry its time beside the plain version,
    ``torch.var_mean`` over (0, 1, 2) and the bound.  Returns the same
    tuple as :func:`phase_bn_kernel`, keyed by NHWC shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    times, fp16_times, path_err, fp16_err, entry_err = {}, {}, 0.0, 0.0, 0.0
    for shape in RESNET50_BN_NHWC:
        for dtype in (torch.float32, torch.float16):
            x = (torch.randn(shape, generator=gen, device=dev) * 0.5) \
                .to(dtype)
            pivot = x[0, 0, 0].float().contiguous()
            before = bs.bn_stats.launches_cl
            m, v = bs.bn_stats(x, pivot, 3)
            torch.cuda.synchronize()
            check(bs.bn_stats.launches_cl == before + 1,
                  f"[bn_stats_cl] {shape} did not take the channels-last "
                  f"entry")
            rm, rv = bs._reference(x, pivot, 3)
            err = max((m - rm).abs().max().item(),
                      (v - rv).abs().max().item())
            check(m.shape == v.shape == (shape[3],) and math.isfinite(err)
                  and err <= 2e-5,
                  f"[bn_stats_cl] disagrees with the plain version at "
                  f"{shape} {dtype}: {err}")
            line = (f"[bn_stats_cl] {shape} {str(dtype)[6:]}: max_abs_err "
                    f"{err:.3e} (tol 2e-05)")
            part, plan = bn_first_pivot_same(bs, x, 3, m, v)
            line += part
            k = device_ms(lambda: bs.bn_stats(x, bs.FIRST, 3))
            bound, by = bn_stats_bound_ms(shape, dtype, 3)
            t = bn_tickets_ms(bs, x, 3, plan)
            if dtype == torch.float16:
                fp16_err = max(fp16_err, err)
                fp16_times[shape] = (k, bound, by, t)
            else:
                path_err = max(path_err, err)
                cf = x.permute(0, 3, 1, 2).contiguous()
                cm, cv = bs.bn_stats(cf, cf[0, :, 0, 0].contiguous())
                e2 = max((m - cm).abs().max().item(),
                         (v - cv).abs().max().item())
                entry_err = max(entry_err, e2)
                check(e2 <= 1e-6, f"[bn_stats_cl] the NHWC and NCHW entries "
                                  f"disagree at {shape}: {e2}")
                pl = device_ms(lambda: bs._reference(x, pivot, 3))
                lib = device_ms(lambda: torch.var_mean(
                    x, dim=(0, 1, 2), unbiased=False))
                times[shape] = (k, pl, lib, bound, by, t)
                line += (f", vs the NCHW entry {e2:.3e} (tol 1e-06); plain "
                         f"{pl:.4f} ms, var_mean {lib:.4f} ms")
            log(line + f"; kernel {k:.4f} ms, bound {bound:.4f} ms ({by}), "
                       f"{bound / k:.2f} of the bound" +
                bn_tickets_part(t, k))
    log(f"[bn_stats_cl] timed on {card}, the kernel reading its own "
        f"pivot; NHWC vs NCHW entry max {entry_err:.3e}")
    bn_wrapper_host("[bn_stats_cl]", bs, (32, 14, 14, 256), 3)
    return times, fp16_times, path_err, fp16_err


def nhwc_params(path):
    """Phase 6's NCHW weights as an NHWC net's ``.params`` file: every 4-D
    weight ``(O, I, kh, kw)`` transposed to ``(O, kh, kw, I)``, as the JAX
    package's NHWC nets store it."""
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    src = get_model("resnet50_v1", classes=1000, device="cpu")
    src.load_parameters(str(path))
    net = get_model("resnet50_v1", classes=1000, layout="NHWC",
                    device="cpu")
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3))         # fixes the deferred widths
    net.load_state_dict({k: v.permute(0, 2, 3, 1) if v.dim() == 4 else v
                         for k, v in src.state_dict().items()})
    out = BUILD / "resnet50_v1_nhwc.params"
    net.save_parameters(str(out))
    return out


def phase_nhwc_parity(bs, path):
    """Phase 21: ResNet-50 v1 ``layout="NHWC"`` at full width and depth,
    batch 8: its fp32 inference logits on the card against the CPU within
    1e-4 of their max, and the NCHW net on the card with the same weights
    (transposed) against them within the same; then phase 8's parity in
    NHWC for 3 SGD steps.  Returns the NHWC ``.params`` path."""
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    path_nhwc = nhwc_params(path)
    x = _images(np.random.RandomState(21), PARITY_BATCH, "NHWC")

    def logits(layout, device, p):
        net = get_model("resnet50_v1", classes=1000, layout=layout,
                        device=device)
        net.load_parameters(str(p))
        data = x if layout == "NHWC" else x.transpose(0, 3, 1, 2)
        with torch.inference_mode():
            return net(torch.from_numpy(np.ascontiguousarray(data))
                       .to(device)).float().cpu().numpy()

    ref = logits("NHWC", "cpu", path_nhwc)
    card = logits("NHWC", "cuda", path_nhwc)
    nchw = logits("NCHW", "cuda", path)
    scale = float(np.abs(ref).max())
    for what, got in (("NHWC card", card), ("NCHW card", nchw)):
        err = float(np.abs(got - ref).max())
        log(f"[nhwc] fp32 logits, {what} vs NHWC CPU: max_abs_err "
            f"{err:.3e}, {err / scale:.3e} of max|logit| {scale:.3f} (tol "
            f"1e-4)")
        check(np.isfinite(got).all() and err <= 1e-4 * scale,
              f"[nhwc] {what} logits disagree with the CPU")
    phase_train_parity(bs, path_nhwc, "NHWC", NHWC_PARITY_STEPS)
    return path_nhwc


def _mlp_params(rng):
    """A small MLP's parameters (784-128-64-10 as weight, bias pairs)."""
    shapes = [(128, 784), (128,), (64, 128), (64,), (10, 64), (10,)]
    return shapes, [rng.randn(*s).astype("float32") * 0.1 for s in shapes]


TRAIN_LOOP_OPTS = [
    ("signum", dict(learning_rate=0.01, momentum=0.9, wd=1e-3)),
    ("ftml", dict(learning_rate=0.01, wd=1e-3)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9, warmup_strategy="lars",
                   batch_scale=2)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("sgld", dict(learning_rate=0.01, wd=1e-3)),
    ("ccsgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adagrad", dict(learning_rate=0.1, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01, wd=1e-3, clip_gradient=0.5)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, wd=1e-3)),
    ("adadelta", dict(wd=1e-3)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.01, wd=1e-3)),
    ("adamax", dict(learning_rate=0.002, wd=1e-3)),
    ("nadam", dict(learning_rate=0.001, wd=1e-3)),
    ("test", dict(rescale_grad=0.5)),
]


def _opt_run(name, kw, device, ws, grads, aggregate):
    from mxnet_tpu_torch import optimizer, random
    random.seed(10)
    o = optimizer.create(name, **kw)
    o.aggregate_num = 256 if aggregate else 1
    up = optimizer.get_updater(o)
    tw = [torch.tensor(w, device=device) for w in ws]     # copies
    idx = list(range(len(ws)))
    for gs in grads:
        up(idx, [torch.tensor(g, device=device) for g in gs], tw)
    return tw


def _held_max(tag, what, got, ref, tol):
    err = max(float((a.float().cpu() - b).abs().max())
              / max(float(b.abs().max()), 1e-30) for a, b in zip(got, ref))
    check(math.isfinite(err) and err <= tol,
          f"{tag} {what}: card vs CPU {err:.3e} of the tensor's max > "
          f"{tol:g}")
    return err


def phase_training_loop(card, device="cuda"):
    """Phase 23: the rest of the training loop on the card.  Each
    optimizer of slice 10 (and AdamW through its op) takes 3 grouped
    updates of an MLP's parameters with seeded gradients, card against
    CPU within 1e-5 of each tensor's max (SGLD by its noise: mean and
    variance of the card's step minus the deterministic part, 5 standard
    errors); each grouped rule equals its per-parameter update bit for
    bit on the card; every new loss and its input gradient, and a
    ``backward(create_graph=True)`` second derivative, card against CPU
    within 1e-5 of the tensor's max."""
    from mxnet_tpu_torch import autograd, gluon, optimizer
    from mxnet_tpu_torch.ops import optimizer_ops
    from mxnet_tpu_torch.optimizer.aggregate import _RULES
    rng = np.random.RandomState(23)
    shapes, ws = _mlp_params(rng)
    grads = [[rng.randn(*s).astype("float32") for s in shapes]
             for _ in range(3)]
    worst, grouped = 0.0, []
    for name, kw in TRAIN_LOOP_OPTS:
        ref = _opt_run(name, kw, "cpu", ws, grads, True)
        got = _opt_run(name, kw, device, ws, grads, True)
        if name == "sgld":
            lr, wd = kw["learning_rate"], kw["wd"]
            w = torch.from_numpy(ws[0]).double()
            for gs in grads:   # the deterministic part, step by step
                w = w - lr / 2 * (torch.from_numpy(gs[0]).double() + wd * w)
            # each step adds N(0, lr): three steps N(0, 3 lr) in total,
            # less the small decay of the earlier steps' noise
            noise = got[0].double().cpu() - w
            n = noise.numel()
            ok = abs(float(noise.mean())) < 5 * math.sqrt(3 * lr / n) and \
                abs(float(noise.var()) / (3 * lr) - 1) < 0.01 + \
                5 * math.sqrt(2.0 / n)
            log(f"[train_loop] sgld: noise mean {float(noise.mean()):.3e}, "
                f"variance {float(noise.var()):.4e} (3 lr = {3 * lr:g})")
            check(ok, "[train_loop] SGLD's noise has the wrong moments")
            continue
        err = _held_max("[train_loop]", name, got, ref, 1e-5)
        worst = max(worst, err)
        if type(optimizer.create(name, **kw)) in _RULES:
            per = _opt_run(name, kw, device, ws, grads, False)
            check(all(torch.equal(a, b) for a, b in zip(got, per)),
                  f"[train_loop] {name}: grouped and per-parameter updates "
                  f"differ on the card")
            grouped.append(name)
        log(f"[train_loop] {name} {kw}: card vs CPU {err:.3e} of the "
            f"tensor's max (tol 1e-05)")
    # AdamW through its op
    outs = []
    for dev in ("cpu", device):
        w, m, v = (torch.tensor(a, device=dev) for a in
                   (ws[0], np.zeros_like(ws[0]), np.zeros_like(ws[0])))
        for gs in grads:
            optimizer_ops.adamw_update(w, torch.tensor(gs[0], device=dev),
                                       m, v, lr=0.01, eta=0.5, wd=0.01,
                                       rescale_grad=0.5)
        outs.append([w, m, v])
    err = _held_max("[train_loop]", "adamw_update", outs[1], outs[0], 1e-5)
    log(f"[train_loop] adamw_update: card vs CPU {err:.3e} (tol 1e-05); "
        f"grouped == per-parameter bit for bit on the card: {grouped}")
    worst = max(worst, err)

    # the losses and their gradients
    lrng = np.random.RandomState(24)
    pred = lrng.randn(16, 10).astype("float32")
    cases = [
        ("SigmoidBinaryCrossEntropyLoss", {},
         [pred, (lrng.rand(16, 10) > 0.5).astype("float32")]),
        ("KLDivLoss", {"from_logits": False},
         [pred, lrng.dirichlet(np.ones(10), 16).astype("float32")]),
        ("HuberLoss", {"rho": 0.5}, [pred, lrng.randn(16, 10)]),
        ("HingeLoss", {}, [pred, np.sign(lrng.randn(16, 10))]),
        ("SquaredHingeLoss", {}, [pred, np.sign(lrng.randn(16, 10))]),
        ("LogisticLoss", {}, [pred, np.sign(lrng.randn(16, 10))]),
        ("TripletLoss", {}, [pred, lrng.randn(16, 10),
                             lrng.randn(16, 10)]),
        ("PoissonNLLLoss", {}, [pred, lrng.poisson(2.0, (16, 10))]),
        ("CosineEmbeddingLoss", {}, [pred, lrng.randn(16, 10),
                                     np.sign(lrng.randn(16))]),
        ("CTCLoss", {}, [lrng.randn(4, 20, 8),
                         lrng.randint(0, 7, (4, 5))]),
    ]
    for name, kw, arrays in cases:
        res = []
        for dev in ("cpu", device):
            ins = [torch.tensor(np.asarray(a, "float32"), device=dev)
                   for a in arrays]
            autograd.mark_variables(ins[0], torch.zeros_like(ins[0]))
            with autograd.record():
                loss = getattr(gluon.loss, name)(**kw)(*ins)
            autograd.backward(loss)
            res.append([loss.detach(), ins[0].grad])
        err = _held_max("[train_loop]", f"{name} and its gradient", res[1],
                        [t.cpu() for t in res[0]], 1e-5)
        worst = max(worst, err)
        log(f"[train_loop] {name}: loss and input gradient, card vs CPU "
            f"{err:.3e} (tol 1e-05)")
    # second order through backward(create_graph=True)
    res = []
    for dev in ("cpu", device):
        x = torch.tensor([0.5, -1.0, 2.0, 0.25], device=dev)
        autograd.mark_variables(x, torch.zeros_like(x))
        with autograd.record():
            y = (torch.sin(x) * x * x).sum()
        autograd.backward(y, create_graph=True)
        first = x.grad.detach().clone()
        with autograd.record():
            z = (x.grad * x.grad).sum()
        autograd.backward(z)
        res.append([first, x.grad])
    err = _held_max("[train_loop]", "backward(create_graph=True)", res[1],
                    [t.cpu() for t in res[0]], 1e-5)
    log(f"[train_loop] backward(create_graph=True) second order: card vs "
        f"CPU {err:.3e} (tol 1e-05); worst of the phase {max(worst, err):.3e}"
        f"; on {card}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    # the module, not the function of the same name that ops re-exports
    fa = importlib.import_module("mxnet_tpu_torch.ops.flash_attention")

    card = phase_environment()
    phase_build()
    record = phase_kernel(fa, card)
    grad = phase_flash_grad(fa, card)
    record["train"].update(grad.pop("train_backward"))
    record.update(grad)
    record["launches"] = phase_slice(fa, card)
    rtc_record = phase_rtc(card)
    path = phase_resnet(card)
    bs = importlib.import_module("mxnet_tpu_torch.ops.bn_stats")
    times, fp16_times, bn_err, bn_fp16_err = phase_bn_kernel(bs, card)
    phase_train_parity(bs, path)
    launches, counts, train_ms, train_peak = phase_train(bs, path, card)
    bn = bn_record(times, fp16_times, counts, bn_err, bn_fp16_err, launches)
    phase_pretrain_parity(fa)
    # the pretraining batch's counts beside the kernel's times at its shape
    train = record["train"]
    train["launches"], train["backward_calls"], step_ms, peak = \
        phase_pretrain(fa, card)
    record["nd_launches"], bn["nd_launches"] = phase_nd(fa, bs, card)
    train["nd_launches"], train["nd_backward_calls"] = \
        phase_nd_pretrain(fa, card, step_ms, peak)
    phase_module_parity(bs)
    bn["module_launches"] = phase_module(bs, card, train_ms, train_peak)
    # slice 9: mixed precision
    train["amp_parity_launches"] = phase_amp_pretrain_parity(fa)
    amp_launches, amp_calls, amp_ms, amp_peak = phase_pretrain(
        fa, card, amp_on=True)
    train["amp_launches"], train["amp_backward_calls"] = amp_launches, \
        amp_calls
    log(f"[amp_pretrain] AMP step {amp_ms:.3f} ms against phase 11's fp32 "
        f"{step_ms:.3f} ms ({step_ms / amp_ms:.2f}x); peak "
        f"{amp_peak / 2**30:.3f} GiB against {peak / 2**30:.3f} GiB")
    phase_amp_train_parity(bs, path)
    bn["amp_launches"], _, amp_train_ms, amp_train_peak = phase_train(
        bs, path, card, amp_on=True)
    log(f"[amp_train] AMP step {amp_train_ms:.3f} ms against phase 9's fp32 "
        f"{train_ms:.3f} ms ({train_ms / amp_train_ms:.2f}x); peak "
        f"{amp_train_peak / 2**30:.3f} GiB against "
        f"{train_peak / 2**30:.3f} GiB")
    bn["fp16_launches"] = phase_fp16_and_symbolic(bs, path, card)
    # slice 10: channels-last training and the rest of the training loop
    cl_times, cl_fp16, cl_err, cl_fp16_err = phase_bn_kernel_cl(bs, card)
    path_nhwc = phase_nhwc_parity(bs, path)
    cl_launches, cl_counts, nhwc_ms, nhwc_peak = phase_train(
        bs, path_nhwc, card, layout="NHWC")
    bn_cl = bn_record(cl_times, cl_fp16, cl_counts, cl_err, cl_fp16_err,
                      cl_launches, name="bn_stats_cl")
    bn_cl["amp_launches"], _, nhwc_amp_ms, nhwc_amp_peak = phase_train(
        bs, path_nhwc, card, amp_on=True, layout="NHWC")
    log(f"[nhwc_train] NHWC step fp32 {nhwc_ms:.3f} ms, AMP "
        f"{nhwc_amp_ms:.3f} ms, against NCHW fp32 {train_ms:.3f} ms (phase "
        f"9) and AMP {amp_train_ms:.3f} ms (phase 18) in this call; peak "
        f"{nhwc_peak / 2**30:.3f} and {nhwc_amp_peak / 2**30:.3f} GiB")
    phase_training_loop(card)
    print(json.dumps({"kernels": [record, rtc_record, bn, bn_cl]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
