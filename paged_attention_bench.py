#!/usr/bin/env python3
"""Build, check and time the paged decode attention kernel on one GPU.

    python3 paged_attention_bench.py [--quick] [--baseline PATH]

Builds the package's kernel library (``mxnet_tpu_torch/ops/_build.py``)
and prints the ``ptxas -v`` lines of every paged attention kernel.
``--baseline`` also builds PATH, an earlier ``csrc/paged_attention.cu``
with the earlier C entry ``mxt_paged_attention(q, k_pool, v_pool,
k_scale, k_mid, v_scale, v_mid, tables, positions, out, b, nq, heads, d,
page_size, n_tab, quant, device, stream)`` (e.g. ``git show
<commit>:mxnet_tpu_torch/csrc/paged_attention.cu`` saved under
``build/``), with the package's flags, alone in a library of its own.

Checks, at GPT-2 small's served shape of ``chip_smoke.py`` phase 27 (a)
(batch 8, 12 heads of 64, a 1024-token table, positions 200-639) and at
D 32 with 8 heads, over fp32, int8 and fp8 pools: each library against
the plain version (``DEC_KERNEL_TOL`` of the largest magnitude), step
and verify (K = 4), and bit for bit against itself for a row alone, a
permuted batch, moved pages and the verify's query j against a step at
p + j.  ``--quick`` stops there.  Then times, in turns (baseline,
kernel, kernel, baseline), one step's and one verify's 12 layers for
each pool kind, warm (one layer's pools) and cold (12 layers' pools in
turn), each beside the plain version, ``_kv_gather`` +
``F.scaled_dot_product_attention`` and the bound.  Exits non-zero if a
build or a check fails or no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.ops import _build  # noqa: E402
from mxnet_tpu_torch.ops import paged_attention as pa  # noqa: E402
from mxnet_tpu_torch.serving import decode as dec  # noqa: E402

OUT = ROOT / "build" / "paged_attention_bench"


def log(msg):
    print(msg, flush=True)


def build(baseline):
    """The package's library, and the baseline's (or None); prints the
    ptxas lines of the paged attention kernels."""
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
                entry = m.group(1) if "paged_attention" in m.group(1) \
                    else None
                if entry:
                    log(f"[ptxas] {name}: {entry}")
            elif entry and ("registers" in line or "spill" in line):
                log(f"[ptxas] {name}:   {line.strip()}")
    if not baseline:
        return None
    lib = ctypes.CDLL(str(OUT / "lib_baseline.so"))
    lib.mxt_paged_attention.argtypes = [ctypes.c_void_p] * 10 + \
        [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.mxt_paged_attention.restype = ctypes.c_int
    return lib


def baseline_attention(lib):
    """``paged_attention(q, k, v, tables, positions, quant)`` through the
    earlier C entry (the wrapper's checks are the package's)."""
    def call(q, k_pool, v_pool, tables, positions, quant=None):
        code = pa._quant_code(k_pool, quant)
        sides = list(quant or ())
        if code == 2:
            sides = [sides[0], None, sides[1], None]
        elif code == 0:
            sides = [None] * 4
        b, nq, h, d = q.shape
        out = torch.empty_like(q)
        rc = lib.mxt_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            *[None if t is None else t.data_ptr() for t in sides],
            tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, nq, h, d, k_pool.shape[1], tables.shape[1], code,
            q.get_device(), torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline paged attention launch failed "
                               f"({rc})")
        return out
    return call


def checks(fns):
    ok = True
    heads, d = cs.GPT2["num_heads"], cs.GPT2["units"] // cs.GPT2["num_heads"]
    pos = torch.tensor(cs.PA_POSITIONS, dtype=torch.int32, device="cuda")
    for name, fn in fns.items():
        rng = np.random.RandomState(28)
        for kind in cs.PA_KINDS:
            for dd, hh in ((d, heads), (32, 8)):
                err, bad = cs._pa_contract_failures(fn, pa, dec, kind, rng,
                                                    hh, dd, pos)
                torch.cuda.synchronize()
                ok &= not bad
                log(f"[check] {name} {kind} D={dd}: max |err| {err:.3e} "
                    f"against the plain version, step and verify K=4; "
                    + ("rows alone, a permuted batch, moved pages and "
                       "verify query j == the step at p + j, bit for bit"
                       if not bad else "FAILED: " + "; ".join(bad)))
    tickets = [int(t[1].count_nonzero()) for t in pa._scratch.values()]
    ok &= not any(tickets)
    log(f"[check] tickets left non-zero: {sum(tickets)}")
    return ok


def timings(fns):
    """Each variant in turns, then the plain version and gather + SDPA,
    each pool kind, step and verify, warm and cold, beside the bound."""
    heads, d = cs.GPT2["num_heads"], cs.GPT2["units"] // cs.GPT2["num_heads"]
    n_tab = cs.GPT2["max_length"] // cs.DEC_PAGE
    layers = cs.GPT2["num_layers"]
    order = list(fns) + list(reversed(fns))
    runs = {k: [] for k in fns}
    for turn, k in enumerate(order):
        got = cs._pa_times({k: fns[k]}, pa, dec,
                           np.random.RandomState(40 + turn))
        runs[k].append(got)
        for (kind, nq), row in got.items():
            warm, cold = row[k]
            log(f"[time] {k} {kind} {'step' if nq == 1 else 'verify K=4'}"
                f" ({layers} layers): warm {warm:.4f} ms, cold {cold:.4f} "
                f"ms")
    yard = cs._pa_times({"plain": pa._reference,
                         "gather + SDPA": lambda *a: cs._sdpa_on_gathered(
                             pa, *a)}, pa, dec, np.random.RandomState(50))
    for (kind, nq), row in yard.items():
        bound, by, nbytes = cs._pa_bound_ms(cs.PA_POSITIONS, nq, heads, d,
                                            kind, n_tab)
        what = f"{kind} {'step' if nq == 1 else 'verify K=4'} " \
            f"({layers} layers)"
        for k, r in runs.items():
            warm = sum(g[(kind, nq)][k][0] for g in r) / len(r)
            cold = sum(g[(kind, nq)][k][1] for g in r) / len(r)
            log(f"[time] {k} mean of {len(r)}, {what}: warm {warm:.4f} ms, "
                f"cold {cold:.4f} ms; {layers * bound / cold:.3f} of the "
                f"bound cold")
        log(f"[time] {what}: plain warm {row['plain'][0]:.4f} ms; gather + "
            f"SDPA warm {row['gather + SDPA'][0]:.4f} ms, cold "
            f"{row['gather + SDPA'][1]:.4f} ms; bound {layers * bound:.4f} "
            f"ms ({by}, {nbytes / 1e6:.2f} MB a layer)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check only")
    ap.add_argument("--baseline", type=Path,
                    help="an earlier paged_attention.cu to check and time "
                         "against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_attention_bench: no CUDA device visible",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    log(f"[card] {card}")
    lib = build(args.baseline)
    fns = {"kernel": pa.paged_attention}
    if lib is not None:
        fns = {"baseline": baseline_attention(lib), "kernel":
               pa.paged_attention}
    if not checks(fns):
        log("[check] FAILED")
        return 1
    if not args.quick:
        timings(fns)
    log(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
