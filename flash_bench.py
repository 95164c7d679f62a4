#!/usr/bin/env python3
"""Build, check and time variants of the flash-attention kernel on one GPU.

    python3 flash_bench.py [--quick] [--extra NAME=PATH ...]

Builds ``mxnet_tpu_torch/csrc/flash_attention.cu`` and each ``--extra``
source (a trial copy or an earlier version with the same C interface, e.g.
``git show <commit>:mxnet_tpu_torch/csrc/flash_attention.cu`` saved under
``build/``) into a library of its own, the same way and with the same
flags as the package's build (``mxnet_tpu_torch/ops/_build.py``), all at
once.  It prints ``ptxas -v`` per kernel and, from ``cuobjdump -sass``,
the tensor-core (HMMA), fp32 FMA (FFMA), ``cp.async`` (LDGSTS) and
``ldmatrix`` (LDSM) instructions of each kernel with an opcode histogram
of the fp32 bucket-64 one, then holds every variant against the plain
version (fp32 atol 1e-4, bf16/fp16 2e-2), checks bitwise-equal reruns, and
prints each fp32 variant's distance from float64 beside the plain
version's and SDPA's, at normal and at large scores.  ``--quick`` stops
there.  The timing table follows: each variant, the plain version and
``F.scaled_dot_product_attention`` in turns (forward order, then reverse),
at (8, 12, 128, 64) and (8, 12, 512, 64), fp32 and bf16, causal off and
on, with the bounds of ``chip_smoke.py``.  Exits non-zero if a build or a
check fails or no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from chip_smoke import attention_bound_ms, device_ms  # noqa: E402
from mxnet_tpu_torch.ops import _build  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402

KERNEL = ROOT / "mxnet_tpu_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_bench"
SHAPES = [(8, 12, 128, 64), (8, 12, 512, 64)]
CHECKS = [((8, 12, 128, 64), torch.float32), ((8, 12, 512, 64), torch.float32),
          ((2, 2, 200, 64), torch.float32), ((2, 2, 256, 128), torch.float32),
          ((1, 3, 77, 40), torch.float32), ((1, 2, 17, 30), torch.float32),
          ((8, 12, 128, 64), torch.bfloat16), ((1, 3, 65, 100), torch.bfloat16),
          ((8, 12, 128, 64), torch.float16), ((1, 2, 15, 8), torch.float16)]


def log(msg):
    print(msg, flush=True)


def build(variants):
    """{name: flash-attention source} -> {name: bound library}: each source
    in place of the package's own, linked with the package's other sources;
    prints the ptxas lines of each."""
    assert KERNEL in _build.SOURCES

    def one(name):
        srcs = [variants[name] if s == KERNEL else s for s in _build.SOURCES]
        return _build.link(srcs, OUT / f"lib_{name}.so")

    with ThreadPoolExecutor(len(variants)) as pool:
        texts = dict(zip(variants, pool.map(one, variants)))
    libs = {}
    for name, text in texts.items():
        entry = None  # the flash kernel whose ptxas lines these are
        for line in text.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = m.group(1) if "fa_forward" in m.group(1) else None
                if entry:
                    log(f"[ptxas] {name}: {demangle(entry)}")
            elif entry and ("registers" in line or "spill" in line):
                log(f"[ptxas] {name}:   {line.strip()}")
        libs[name] = _build.bind(ctypes.CDLL(str(OUT / f"lib_{name}.so")))
    return libs


def demangle(sym):
    """The template arguments of a mangled fa_forward_kernel<T, DMAX>."""
    m = re.search(r"fa_forward_kernel(I[^E]*E)", sym)
    if not m:
        return sym
    kinds = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "half"}
    args = m.group(1)
    t = next((v for k, v in kinds.items() if args.startswith("I" + k)), "?")
    dmax = re.search(r"Li(\d+)E", args)
    return f"fa_forward_kernel<{t}, {dmax.group(1) if dmax else '?'}>"


def sass_counts(name):
    """HMMA, FFMA, LDGSTS, LDSM instruction counts per kernel of a library,
    and the opcode histogram of the fp32 bucket-64 kernel."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(OUT / f"lib_{name}.so")],
                          capture_output=True, text=True)
    if proc.returncode:
        log(f"[sass] {name}: cuobjdump failed: {proc.stderr.strip()[:200]}")
        return
    ops, func = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = demangle(m.group(1))
            ops[func] = {}
            continue
        # /*0a10*/  @!P0 HMMA.1688.F32.TF32 R4, ... -> HMMA
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if func and m:
            ops[func][m.group(1)] = ops[func].get(m.group(1), 0) + 1
    for func, hist in ops.items():
        if "fa_forward" not in func:
            continue
        log(f"[sass] {name}: {func}: " +
            ", ".join(f"{op} {hist.get(op, 0)}"
                      for op in ("HMMA", "FFMA", "LDGSTS", "LDSM")) +
            f"; {sum(hist.values())} instructions")
    top = sorted(ops.get("fa_forward_kernel<float, 64>", {}).items(),
                 key=lambda kv: -kv[1])[:16]
    log(f"[sass] {name}: fa_forward_kernel<float, 64> by opcode: " +
        ", ".join(f"{k} {v}" for k, v in top))


def call(lib, q, k, v, causal):
    return fa._launch(lib, q, k, v, causal, q.shape[-1] ** -0.5)


def inputs(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype("float32"))
            .to("cuda", dtype) for _ in range(3)]


def check(libs):
    ok = True
    for name, lib in libs.items():
        worst = {}
        for shape, dtype in CHECKS:
            q, k, v = inputs(shape, dtype)
            for causal in (False, True):
                out = call(lib, q, k, v, causal)
                again = call(lib, q, k, v, causal)
                torch.cuda.synchronize()
                ref = fa._reference(q.float(), k.float(), v.float(), causal,
                                    shape[-1] ** -0.5)
                err = (out.float() - ref).abs().max().item()
                tol = 1e-4 if dtype == torch.float32 else 2e-2
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), err)
                if not (err <= tol and torch.equal(out, again)):
                    ok = False
                    log(f"[check] {name} {shape} {key} causal={causal}: "
                        f"max_abs_err {err:.3e} (tol {tol:g}), rerun equal "
                        f"{torch.equal(out, again)} FAILED")
        log(f"[check] {name}: worst max_abs_err " +
            ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return ok


def truth(q, k, v, causal, scale):
    """Dense attention in float64: the answer both fp32 versions approach."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    if causal:
        t = s.shape[-1]
        mask = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())


def accuracy(libs):
    """fp32 error against float64 at normal and at large scores (q and k
    scaled by 8), beside the plain version's and SDPA's own."""
    for mul in (1.0, 8.0):
        q, k, v = inputs((2, 3, 200, 64), torch.float32, seed=3)
        q, k = q * mul, k * mul
        scale = 64 ** -0.5
        for causal in (False, True):
            exact = truth(q, k, v, causal, scale)
            outs = {n: call(lib, q, k, v, causal) for n, lib in libs.items()}
            outs["plain"] = fa._reference(q, k, v, causal, scale)
            outs["sdpa"] = F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale)
            log(f"[accuracy] q, k x{mul:g} causal={causal}: max_abs_err vs "
                f"float64 " + ", ".join(
                    f"{n} {(o.double() - exact).abs().max().item():.3e}"
                    for n, o in outs.items()) +
                "; new vs plain " + ", ".join(
                    f"{n} {(outs[n] - outs['plain']).abs().max().item():.3e}"
                    for n in libs))


def timings(libs, card):
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(shape, dtype, seed=1)
            scale = shape[-1] ** -0.5
            for causal in (False, True):
                fns = {n: (lambda lib=lib: call(lib, q, k, v, causal))
                       for n, lib in libs.items()}
                fns["plain"] = lambda: fa._reference(q, k, v, causal, scale)
                fns["sdpa"] = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=scale)
                order = list(fns) + list(fns)[::-1]
                ms = {n: [] for n in fns}
                for n in order:
                    ms[n].append(device_ms(fns[n]))
                bound, by = attention_bound_ms(shape, dtype, causal)
                fma = (attention_bound_ms(shape, dtype, causal,
                                          peak=67e12)[0]
                       if dtype == torch.float32 else None)
                log(f"[time] {shape} {str(dtype)[6:]} causal={causal}: " +
                    ", ".join(f"{n} {a:.4f}/{b:.4f}"
                              for n, (a, b) in ms.items()) +
                    f" ms (forward/reverse turn); bound {bound:.4f} ms ({by})"
                    + (f", fp32 FMA bound {fma:.4f} ms" if fma else "") +
                    f"; on {card}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build, print ptxas and SASS counts, check, stop")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another source with the same C interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device visible", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = {"kernel": KERNEL}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        variants[name] = Path(path).resolve()
    libs = build(variants)
    for name in libs:
        sass_counts(name)
    ok = check(libs)
    accuracy(libs)
    if ok and not args.quick:
        timings(libs, card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
