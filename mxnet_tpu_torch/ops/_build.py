"""Build and load the port's CUDA kernels.

The sources in ``mxnet_tpu_torch/csrc/`` have a plain C interface, so they
are compiled with ``nvcc`` alone (no PyTorch headers: seconds, not minutes),
one ``nvcc -c`` per source, all started together, then linked into one
shared library under ``build/mxnet_tpu_torch/`` at the repository root and
loaded with :mod:`ctypes`.  The library's file name carries a hash
of the sources and flags, so an edited source is never served by a stale
build.  Nothing is built when this module is imported; the first kernel
launch builds.  There is no fallback: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "link", "bind", "nvcc_path", "BUILD_DIR", "SOURCES"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "flash_attention.cu",
           _PKG / "csrc" / "bn_stats.cu")
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# where the CUDA toolkit installs itself when neither CUDA_HOME nor PATH
# names it
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_lib = None
# set by the build that produced the loaded library (None if it was cached)
build_seconds = None
build_log = ""


def nvcc_path():
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's conventional install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append(_DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (looked at {candidates}): the port's CUDA "
        f"kernels cannot be built")


def _digest():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def bind(lib):
    """Declare the C signatures of the library's entry points."""
    f = lib.mxt_flash_attention_fwd
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    bn = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
          ctypes.c_int, ctypes.c_void_p]
    lib.mxt_bn_stats.argtypes = bn
    lib.mxt_bn_stats.restype = ctypes.c_int
    lib.mxt_bn_stats_plan.argtypes = bn + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    lib.mxt_bn_stats_plan.restype = ctypes.c_int
    lib.mxt_error_string.argtypes = [ctypes.c_int]
    lib.mxt_error_string.restype = ctypes.c_char_p
    return lib


def _check(returncode, cmd, out):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{out}")


def load():
    """The kernel library, built on first use (thread-safe)."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / f"libmxnet_tpu_torch_{_digest()}.so"
        if not so.exists():
            t0 = time.perf_counter()
            build_log = link(SOURCES, so)
            build_seconds = time.perf_counter() - t0
        _lib = bind(ctypes.CDLL(str(so)))
        return _lib


def link(sources, so):
    """Compile ``sources`` (one ``nvcc -c`` each, all started together) and
    link them into the shared library ``so``; returns nvcc's output, which
    holds the ``ptxas -v`` lines.  Raises if a step fails."""
    so = Path(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    # private names, then an atomic rename: a concurrent build in another
    # process never loads a half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(src).stem}.o")
            for src in sources]
    nvcc = nvcc_path()
    compiles = [[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in compiles]
        logs = [proc.communicate()[0] for proc in procs]
        for c, proc, out in zip(compiles, procs, logs):
            _check(proc.returncode, c, out)
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        _check(proc.returncode, cmd, proc.stdout)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)
    return "".join(logs) + proc.stdout
