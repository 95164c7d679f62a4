#!/usr/bin/env python3
"""Build, check and time the row-stable contraction kernel ``rowdot`` on
one GPU.

    python3 rowdot_bench.py [--quick] [--plans] [--baseline PATH]

Builds the package's kernel library (``mxnet_tpu_torch/ops/_build.py``)
and prints the ``ptxas -v`` lines of every rowdot kernel.  ``--baseline``
also builds PATH, an earlier ``csrc/rowdot.cu`` with the earlier C entry
``mxt_rowdot(x, w, bias, y, n, u, v, trans, vec, device, stream)`` (e.g.
``git show <commit>:mxnet_tpu_torch/csrc/rowdot.cu`` saved under
``build/``), with the package's flags, alone in a library of its own.

Checks, at GPT-2 small's shapes of ``chip_smoke.py`` phase 27 (a) (the
four layer contractions and the logits over ``embed.t()``, the same
seeded draws): the kernel against its plain version (``DEC_KERNEL_TOL``
of the largest magnitude) at 8 and 1024 rows, its rows of N = 1..8, 40,
1024 and 4096 bit for bit the 1-row calls, and, with a baseline, every
output of those calls bit for bit the baseline's.  ``--quick`` stops
there.  Then times, in turns (baseline, kernel, kernel, baseline), one
decode step at batch 8 (49 calls) with each shape warm in L2 and with 12
layers' weights in turn (cold, as the served loop reads them), and the
48 calls of a prefill of the (8, 512) bucket, each beside
``torch.matmul`` on the same tensors and the bound.  Exits non-zero if a
build or a check fails or no CUDA device is visible.  ``--plans`` only
times each decode shape under every split of its chunks (warm and cold).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.ops import _build  # noqa: E402
from mxnet_tpu_torch.ops import rowdot as rd  # noqa: E402

OUT = ROOT / "build" / "rowdot_bench"
ROWS = (*range(1, 9), 40, 1024, cs.PREFILL_ROWS)


def log(msg):
    print(msg, flush=True)


def build(baseline):
    """The package's library, and the baseline's (or None); prints the
    ptxas lines of the rowdot kernels."""
    def package():
        _build.load()
        return _build.build_log

    def base():
        return _build.link([baseline], OUT / "lib_baseline.so")
    with ThreadPoolExecutor(2) as pool:
        jobs = {"kernel": pool.submit(package)}
        if baseline:
            jobs["baseline"] = pool.submit(base)
        texts = {k: f.result() for k, f in jobs.items()}
    for name, text in texts.items():
        entry = None
        for line in (text or "").splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = m.group(1) if "rowdot" in m.group(1) else None
                if entry:
                    log(f"[ptxas] {name}: {entry}")
            elif entry and ("registers" in line or "spill" in line):
                log(f"[ptxas] {name}:   {line.strip()}")
    if not baseline:
        return None
    lib = ctypes.CDLL(str(OUT / "lib_baseline.so"))
    lib.mxt_rowdot.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    lib.mxt_rowdot.restype = ctypes.c_int
    return lib


def baseline_rowdot(lib):
    """``rowdot(x, w, bias)`` through the earlier C entry."""
    def call(x, w, bias=None):
        x2 = x.reshape(-1, x.shape[-1])
        u, v = w.shape
        trans = rd._orientation(w)
        y = torch.empty(x.shape[:-1] + (v,), dtype=torch.float32,
                        device=x.device)
        vec = int(u % 4 == 0 and x2.data_ptr() % 16 == 0 and
                  (not trans or w.data_ptr() % 16 == 0))
        rc = lib.mxt_rowdot(
            x2.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            x2.shape[0], u, v, trans, vec, x.get_device(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline rowdot launch failed ({rc})")
        return y
    return call


def shapes():
    """Phase 27 (a)'s draws: (name, n, u, v, trans, per layer, w, b, x)."""
    rng = np.random.RandomState(27)
    for name, n, u, v, trans, per_layer in cs._rowdot_shapes(
            cs.GPT2["units"], 4 * cs.GPT2["units"], cs.GPT2["vocab_size"],
            8):
        w = torch.from_numpy((rng.randn(v, u) if trans else rng.randn(u, v))
                             .astype("float32") * 0.02).cuda()
        w = w.t() if trans else w
        b = None if trans else torch.from_numpy(
            rng.randn(v).astype("float32")).cuda()
        x = torch.from_numpy(rng.randn(cs.PREFILL_ROWS, u)
                             .astype("float32")).cuda()
        yield name, n, u, v, trans, per_layer, w, b, x


def checks(base):
    ok = True
    for name, n, u, v, trans, _, w, b, x in shapes():
        for rows in (8,) if trans else (8, 1024):
            y = rd.rowdot(x[:rows], w, b)
            e = (y - cs._rowdot_plain(rd, x[:rows], w, b)).abs().max().item()
            held = e <= cs.DEC_KERNEL_TOL * y.abs().max().item()
            ok &= held
            log(f"[check] {name} ({rows}, {u}) x ({u}, {v}): max |err| "
                f"{e:.3e} against the plain version "
                f"{'held' if held else 'FAILED'}")
        solo = torch.cat([rd.rowdot(x[r:r + 1], w, b) for r in range(8)])
        same_rows, same_base = True, True
        for rows in ROWS:
            y = rd.rowdot(x[:rows], w, b)
            k = min(rows, 8)
            same_rows &= torch.equal(y[:k], solo[:k])
            if base is not None:
                same_base &= torch.equal(y, base(x[:rows], w, b))
        ok &= same_rows and same_base
        log(f"[check] {name}: rows of N = {', '.join(map(str, ROWS))} "
            f"{'==' if same_rows else '!='} 1-row calls"
            + ("" if base is None else
               f"; every output {'==' if same_base else '!='} the "
               f"baseline's, bit for bit"))
        del x, w, b, solo
    return ok


def timings(fns):
    """{variant: (warm step, cold step, prefill) ms} in turns, and the
    same for torch.matmul and the bounds."""
    cases = list(shapes())
    layers = cs.GPT2["num_layers"]
    units = cs.GPT2["units"]

    def measure(fn, name_fn):
        warm = pre = 0.0
        for name, n, u, v, trans, per_layer, w, b, x in cases:
            xs = x[:n].contiguous()
            ms = cs.device_ms(lambda: fn(xs, w, b), iters=20)
            warm += (layers * per_layer or 1) * ms
            line = f"[shape] {name_fn} {name} ({n}, {u}) x ({u}, {v}): " \
                   f"warm {ms:.4f} ms"
            if per_layer:
                ms = cs.device_ms(lambda: fn(x, w, b), iters=5)
                pre += layers * ms
                line += f", prefill ({cs.PREFILL_ROWS}, {u}) {ms:.4f} ms"
            log(line)
        cold, _, _ = cs._rowdot_cold_step(
            SimpleNamespace(rowdot=fn), np.random.RandomState(5), units,
            4 * units, cs.GPT2["vocab_size"], layers)
        return warm, cold, pre

    order = list(fns) + list(reversed(fns))
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(measure(fns[k], k))
        log(f"[time] {k}: warm step {got[k][-1][0]:.4f} ms, cold step "
            f"{got[k][-1][1]:.4f} ms, prefill {got[k][-1][2]:.4f} ms")

    def matmul(x, w, b=None):
        return torch.matmul(x, w)
    lib = measure(matmul, "torch.matmul")
    bound_step = sum((layers * pl or 1) * cs._rowdot_bound_ms(n, u, v)[0]
                     for _, n, u, v, _, pl, *_ in cases)
    bound_pre = sum(layers * cs._rowdot_bound_ms(cs.PREFILL_ROWS, u, v)[0]
                    for _, _, u, v, _, pl, *_ in cases if pl)
    log(f"[time] torch.matmul: warm step {lib[0]:.4f} ms, cold step "
        f"{lib[1]:.4f} ms, prefill {lib[2]:.4f} ms")
    log(f"[time] bound: step {bound_step:.4f} ms (bytes), prefill "
        f"{bound_pre:.4f} ms (operations)")
    for k, runs in got.items():
        mean = [sum(r[i] for r in runs) / len(runs) for i in range(3)]
        log(f"[time] {k} mean of {len(runs)}: warm step {mean[0]:.4f} ms, "
            f"cold step {mean[1]:.4f} ms, prefill {mean[2]:.4f} ms")


def plans():
    """Each layer shape of the decode step at batch 8 under every split
    (``rd._launch``'s ``plan``; 0 is the automatic choice): ms warm (one
    weight) and cold (12 weights in turn, as a step reads them)."""
    rng = np.random.RandomState(9)
    units = cs.GPT2["units"]
    for name, n, u, v, trans, per_layer in cs._rowdot_shapes(
            units, 4 * units, cs.GPT2["vocab_size"], 8):
        copies = 12 if per_layer else 2
        ws = [torch.from_numpy((rng.randn(v, u) if trans else
                                rng.randn(u, v)).astype("float32")).cuda()
              for _ in range(copies)]
        ws = [w.t() for w in ws] if trans else ws
        x = torch.from_numpy(rng.randn(n, u).astype("float32")).cuda()
        chunks = (u + 63) // 64
        line = []
        for plan in sorted({0, 1, 2, 3, 4, 6, 8, 12, 16, 24, chunks}):
            if plan > chunks:
                continue
            used = torch.zeros(2, dtype=torch.int32)
            rd._launch(x, ws[0], None, plan, used)
            warm = cs.device_ms(lambda: rd._launch(x, ws[0], None, plan),
                                iters=20)

            def cold():
                for w in ws:
                    rd._launch(x, w, None, plan)
            cold_ms = cs.device_ms(cold, iters=4) / copies
            line.append(f"{plan}->{used[1].item()}: {warm * 1e3:.1f}/"
                        f"{cold_ms * 1e3:.1f}")
        log(f"[plans] {name} ({n}, {u}) x ({u}, {v}), splits: warm/cold "
            f"us: " + ", ".join(line))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check only")
    ap.add_argument("--plans", action="store_true",
                    help="time every split of the decode shapes, then stop")
    ap.add_argument("--baseline", type=Path,
                    help="an earlier rowdot.cu to check and time against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rowdot_bench: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    log(f"[card] {card}")
    lib = build(args.baseline)
    base = None if lib is None else baseline_rowdot(lib)
    if args.plans:
        plans()
        return 0
    ok = checks(base)
    if not ok:
        log("[check] FAILED")
        return 1
    if not args.quick:
        fns = {"kernel": rd.rowdot}
        if base is not None:
            fns = {"baseline": base, "kernel": rd.rowdot}
        timings(fns)
    log(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
