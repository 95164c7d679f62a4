"""Runtime-compiled CUDA kernels (counterpart of ``mxnet_tpu/rtc.py``).

The JAX package turns user Pallas source into a callable
(``compile_pallas``) and leaves Apache MXNet's ``CudaModule`` /
``CudaKernel`` as stubs, since a TPU runs no CUDA.  On an NVIDIA GPU CUDA
source is the native form of the same workflow, so here all three are real:

- :class:`CudaModule` compiles CUDA C++ source with NVRTC into a cubin for
  the device's architecture (``sm_90a`` on an H100), as MXNet 1.5's
  ``python/mxnet/rtc.py`` and ``src/common/rtc.cc`` do; ``exports`` names
  templated or C++ kernels, whose mangled names NVRTC reports;
- :meth:`CudaModule.get_kernel` binds a kernel to a C parameter list and
  :meth:`CudaKernel.launch` launches it with ``cuLaunchKernel`` on torch's
  current stream of the tensors' device;
- :func:`compile_cuda` is ``compile_pallas``'s counterpart: source text in,
  ``fn(*tensors) -> tensor`` out.

NVRTC (``libnvrtc.so``, found beside ``nvcc`` in the CUDA toolkit) and the
driver (``libcuda.so.1``) are bound with :mod:`ctypes` when a module is
first built, never at import.  Without them :class:`CudaModule` raises
naming the missing library.  CUDA source has no CPU interpreter, so a CPU
tensor passed to a launch raises; nothing falls back to torch.
``CudaKernel.launches`` counts launches over every kernel.
"""
from __future__ import annotations

import ctypes
import math
import re
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .context import Context
from .ndarray.ndarray import NDArray
from .ops import _build

__all__ = ["CudaModule", "CudaKernel", "compile_cuda", "parse_signature"]

# C type -> torch dtype of a pointer argument (MXNet's _DTYPE_CPP_TO_NP)
_POINTER_TYPES = {
    "float": torch.float32, "double": torch.float64, "__half": torch.float16,
    "uint8_t": torch.uint8, "int8_t": torch.int8, "char": torch.int8,
    "int": torch.int32, "int32_t": torch.int32, "int64_t": torch.int64,
}
# C type -> ctypes type of a scalar argument
_SCALAR_TYPES = {
    "float": ctypes.c_float, "double": ctypes.c_double,
    "__half": ctypes.c_uint16, "uint8_t": ctypes.c_uint8,
    "int8_t": ctypes.c_int8, "char": ctypes.c_int8, "int": ctypes.c_int32,
    "int32_t": ctypes.c_int32, "int64_t": ctypes.c_int64,
}
_C_NAME_OF = {torch.float32: "float", torch.float64: "double",
              torch.float16: "__half", torch.uint8: "uint8_t",
              torch.int8: "int8_t", torch.int32: "int", torch.int64: "int64_t"}
_ARG = re.compile(
    r"^\s*(const)?\s*([A-Za-z_]\w*)\s*(\*)?\s*([A-Za-z_]\w*)?\s*$")

_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_STATIC_SHARED_LIMIT = 48 * 1024


def parse_signature(signature):
    """``"const float *x, float *y, float alpha"`` -> a list of
    ``(is_pointer, is_const, c_type)``, as MXNet's ``CudaKernel`` reads it.
    Raises on a malformed argument or a type it cannot pass."""
    args = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError(
                f"invalid kernel argument {arg.strip()!r}: must read "
                f"'(const) type (*) (name)'")
        is_const, ctype, star = bool(m.group(1)), m.group(2), bool(m.group(3))
        if ctype not in _POINTER_TYPES:
            raise TypeError(f"unsupported argument type {ctype!r}; kernels "
                            f"take {sorted(_POINTER_TYPES)}")
        args.append((star, is_const, ctype))
    return args


# ----------------------------------------------------------------- bindings
class _Lib:
    """NVRTC and the CUDA driver, bound once per process."""

    _lock = threading.Lock()
    nvrtc = None
    cuda = None
    include_dir = None

    @classmethod
    def load(cls):
        with cls._lock:
            if cls.nvrtc is None:
                cls.nvrtc, cls.include_dir = _bind_nvrtc()
            if cls.cuda is None:
                cls.cuda = _bind_driver()
        return cls


def _nvrtc_candidates():
    try:
        root = Path(_build.nvcc_path()).resolve().parent.parent
    except RuntimeError as e:
        raise RuntimeError(
            f"NVRTC (libnvrtc.so), the CUDA runtime compiler, is missing: "
            f"it comes with the CUDA toolkit, and none was found ({e})") \
            from None
    dirs = [root / "lib64", root / "lib", root / "targets" / "x86_64-linux"
            / "lib", root / "targets" / "sbsa-linux" / "lib"]
    names = ["libnvrtc.so"] + sorted(
        (p.name for d in dirs if d.is_dir() for p in d.glob("libnvrtc.so.*")
         if "builtins" not in p.name), reverse=True)
    return root, [d / n for d in dirs for n in names if (d / n).exists()]


def _bind_nvrtc():
    root, paths = _nvrtc_candidates()
    if not paths:
        raise RuntimeError(
            f"NVRTC (libnvrtc.so), the CUDA runtime compiler, is missing: "
            f"not found under the CUDA toolkit at {root}")
    lib = ctypes.CDLL(str(paths[0]))
    p, vp, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
        ctypes.POINTER(ctypes.c_size_t)
    cpp = ctypes.POINTER(ctypes.c_char_p)
    sigs = {
        "nvrtcCreateProgram": [vp, ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int, cpp, cpp],
        "nvrtcDestroyProgram": [vp],
        "nvrtcAddNameExpression": [p, ctypes.c_char_p],
        "nvrtcCompileProgram": [p, ctypes.c_int, cpp],
        "nvrtcGetProgramLogSize": [p, sz],
        "nvrtcGetProgramLog": [p, ctypes.c_char_p],
        "nvrtcGetCUBINSize": [p, sz],
        "nvrtcGetCUBIN": [p, ctypes.c_char_p],
        "nvrtcGetLoweredName": [p, ctypes.c_char_p, cpp],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p
    include = root / "include"
    return lib, (str(include) if include.is_dir() else None)


def _bind_driver():
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise RuntimeError(
            f"the CUDA driver (libcuda.so.1) is missing: mx.rtc launches "
            f"kernels through it ({e})") from None
    p, vp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    ui = ctypes.c_uint
    sigs = {
        "cuInit": [ui],
        "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
        "cuDevicePrimaryCtxRetain": [vp, ctypes.c_int],
        "cuCtxSetCurrent": [p],
        "cuModuleLoadData": [vp, p],
        "cuModuleGetFunction": [vp, p, ctypes.c_char_p],
        "cuFuncSetAttribute": [p, ctypes.c_int, ctypes.c_int],
        "cuLaunchKernel": [p, ui, ui, ui, ui, ui, ui, ui, p, vp, vp],
        "cuGetErrorString": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _cu_check(lib, lib.cuInit(0), "cuInit")
    return lib


def _cu_check(lib, rc, what):
    if rc != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise RuntimeError(f"{what} failed: {text} (CUresult {rc})")


def _nvrtc_check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.nvrtcGetErrorString(rc).decode()}")


_contexts = {}


def _make_current(cuda, index):
    """Make device ``index``'s primary context (the one torch uses) current
    on this thread; a batcher's worker thread may have none."""
    ctx = _contexts.get(index)
    if ctx is None:
        dev = ctypes.c_int()
        _cu_check(cuda, cuda.cuDeviceGet(ctypes.byref(dev), index),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _cu_check(cuda, cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                      dev.value),
                  "cuDevicePrimaryCtxRetain")
        _contexts[index] = ctx
    _cu_check(cuda, cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def _arch(index):
    major, minor = torch.cuda.get_device_capability(index)
    # the "a" target unlocks wgmma/setmaxnreg on Hopper; it exists for 9.0
    return f"sm_{major}{minor}{'a' if (major, minor) == (9, 0) else ''}"


# ------------------------------------------------------------------ module
class CudaModule:
    """CUDA C++ source compiled with NVRTC (MXNet's ``mx.rtc.CudaModule``).

    Parameters
    ----------
    source : str
        The kernels.  ``extern "C"`` kernels are found by name; templated or
        C++ kernels are named in ``exports``.
    options : sequence of str
        Extra NVRTC options (``"--fmad=false"``, ``"-DBLOCK=128"``, ...).
        The architecture (``--gpu-architecture=sm_90a`` on an H100), C++17
        and the toolkit's include directory are always given.
    exports : sequence of str
        Name expressions (``"axpy<float>"``) whose mangled names
        :meth:`get_kernel` looks up.

    The source is compiled for the current device's architecture at
    construction (a compile error raises with NVRTC's log); the cubin is
    loaded once per device, and a device of another architecture raises.
    """

    def __init__(self, source, options=(), exports=()):
        self._lib = _Lib.load()
        if not torch.cuda.is_available():
            raise RuntimeError("mx.rtc.CudaModule needs a CUDA device; "
                               "none is visible")
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self._lock = threading.Lock()
        self._modules = {}         # device index -> CUmodule
        self.arch = _arch(torch.cuda.current_device())
        self.cubin, self._lowered = self._compile(self.arch)

    def _compile(self, arch):
        """``(cubin bytes, {export: mangled name})`` for ``arch``."""
        nvrtc = self._lib.nvrtc
        t0 = time.perf_counter()
        prog = ctypes.c_void_p()
        _nvrtc_check(nvrtc, nvrtc.nvrtcCreateProgram(
            ctypes.byref(prog), self.source.encode(), b"mx_rtc.cu", 0, None,
            None), "nvrtcCreateProgram")
        try:
            for name in self.exports:
                _nvrtc_check(nvrtc, nvrtc.nvrtcAddNameExpression(
                    prog, name.encode()), f"nvrtcAddNameExpression({name})")
            opts = [f"--gpu-architecture={arch}", "--std=c++17"]
            if self._lib.include_dir:
                opts.append(f"--include-path={self._lib.include_dir}")
            opts += list(self.options)
            c_opts = (ctypes.c_char_p * len(opts))(*(o.encode()
                                                     for o in opts))
            rc = nvrtc.nvrtcCompileProgram(prog, len(opts), c_opts)
            size = ctypes.c_size_t()
            nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            nvrtc.nvrtcGetProgramLog(prog, log)
            if rc != 0:
                raise RuntimeError(
                    f"NVRTC failed to compile the kernel source for {arch} "
                    f"({nvrtc.nvrtcGetErrorString(rc).decode()}):\n"
                    f"{log.value.decode(errors='replace')}")
            _nvrtc_check(nvrtc, nvrtc.nvrtcGetCUBINSize(
                prog, ctypes.byref(size)), "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            _nvrtc_check(nvrtc, nvrtc.nvrtcGetCUBIN(prog, cubin),
                         "nvrtcGetCUBIN")
            lowered = {}
            for name in self.exports:
                out = ctypes.c_char_p()
                _nvrtc_check(nvrtc, nvrtc.nvrtcGetLoweredName(
                    prog, name.encode(), ctypes.byref(out)),
                    f"nvrtcGetLoweredName({name})")
                lowered[name] = out.value.decode()
        finally:
            nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))
        self.compile_seconds = time.perf_counter() - t0
        return cubin.raw, lowered

    def _module(self, index):
        """The cubin loaded on device ``index``; the context is made
        current."""
        if _arch(index) != self.arch:
            raise RuntimeError(f"the module was compiled for {self.arch}; "
                               f"device {index} is {_arch(index)}")
        cuda = self._lib.cuda
        with self._lock:
            _make_current(cuda, index)
            mod = self._modules.get(index)
            if mod is None:
                mod = ctypes.c_void_p()
                _cu_check(cuda, cuda.cuModuleLoadData(ctypes.byref(mod),
                                                      self.cubin),
                          "cuModuleLoadData")
                self._modules[index] = mod
            return mod

    def _function(self, index, name):
        mod = self._module(index)
        lowered = self._lowered.get(name, name)
        fn = ctypes.c_void_p()
        _cu_check(self._lib.cuda, self._lib.cuda.cuModuleGetFunction(
            ctypes.byref(fn), mod, lowered.encode()),
            f"cuModuleGetFunction({name!r} as {lowered!r})")
        return fn

    def get_kernel(self, name, signature):
        """A :class:`CudaKernel` for kernel ``name`` (an ``extern "C"``
        name or one of ``exports``) taking ``signature``."""
        kernel = CudaKernel(self, name, signature)
        kernel._function(torch.cuda.current_device())   # raise early
        return kernel


class CudaKernel:
    """A kernel of a :class:`CudaModule` bound to its C parameter list
    (MXNet's ``mx.rtc.CudaKernel``).  Made by
    :meth:`CudaModule.get_kernel`."""

    launches = 0            # over every kernel; only real launches count

    def __init__(self, module, name, signature):
        if not isinstance(module, CudaModule):
            raise TypeError("a CudaKernel comes from CudaModule.get_kernel")
        self._module = module
        self.name = name
        self.signature = parse_signature(signature)
        self._functions = {}

    def _function(self, index):
        fn = self._functions.get(index)
        if fn is None:
            fn = self._functions[index] = \
                self._module._function(index, self.name)
        return fn

    def _device(self, args, ctx):
        """The device index every tensor argument and ``ctx`` agree on
        (``cuda`` without an index is the current device)."""
        devices = [a.device for a in args if isinstance(a, torch.Tensor)]
        if ctx is not None:
            devices.append(ctx.torch_device() if isinstance(ctx, Context)
                           else torch.device(ctx))
        if any(d.type != "cuda" for d in devices):
            raise ValueError(
                f"kernel {self.name!r}: CUDA source runs on a CUDA device "
                f"only, got {sorted(set(map(str, devices)))}")
        indices = {torch.cuda.current_device() if d.index is None
                   else d.index for d in devices}
        if len(indices) > 1:
            raise ValueError(f"kernel {self.name!r}: arguments and context "
                             f"span devices {sorted(indices)}")
        return indices.pop() if indices else torch.cuda.current_device()

    def _pack(self, args):
        """ctypes values for ``args``, checked against the signature."""
        if len(args) != len(self.signature):
            raise ValueError(f"kernel {self.name!r} takes "
                             f"{len(self.signature)} arguments, got "
                             f"{len(args)}")
        values = []
        for i, (arg, (is_ptr, _, ctype)) in enumerate(zip(args,
                                                          self.signature)):
            if is_ptr:
                if not isinstance(arg, torch.Tensor):
                    raise TypeError(f"argument {i} of {self.name!r} is a "
                                    f"{ctype} pointer: pass a tensor")
                if arg.dtype != _POINTER_TYPES[ctype]:
                    raise TypeError(
                        f"argument {i} of {self.name!r} is a {ctype} "
                        f"pointer, got a {arg.dtype} tensor")
                if not arg.is_contiguous():
                    raise ValueError(f"argument {i} of {self.name!r} must "
                                     f"be contiguous")
                values.append(ctypes.c_void_p(arg.data_ptr()))
            else:
                if isinstance(arg, torch.Tensor):
                    raise TypeError(f"argument {i} of {self.name!r} is a "
                                    f"{ctype} scalar: pass a number")
                if ctype == "__half":
                    arg = int(np.float16(arg).view(np.uint16))
                elif ctype not in ("float", "double"):
                    if int(arg) != arg:
                        raise TypeError(f"argument {i} of {self.name!r} is "
                                        f"a {ctype}, got {arg!r}")
                    arg = int(arg)
                values.append(_SCALAR_TYPES[ctype](arg))
        return values

    def launch(self, args, ctx=None, grid_dims=(1, 1, 1),
               block_dims=(1, 1, 1), shared_mem=0):
        """Launch on ``grid_dims`` blocks of ``block_dims`` threads with
        ``shared_mem`` bytes of dynamic shared memory, on torch's current
        stream of the arguments' device.  A pointer argument is a tensor or
        an ``mx.nd`` NDArray (its tensor), as MXNet's ``launch`` takes
        NDArrays.  ``ctx`` (``mx.gpu(i)`` or a torch
        device) must agree with the tensors; the launch does not
        synchronise.  Raises with the driver's message if it is refused."""
        args = [a._data if isinstance(a, NDArray) else a for a in args]
        values = self._pack(args)
        index = self._device(args, ctx)
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        fn = self._function(index)
        cuda = self._module._lib.cuda
        with self._module._lock:
            _make_current(cuda, index)
            if shared_mem > _STATIC_SHARED_LIMIT:
                _cu_check(cuda, cuda.cuFuncSetAttribute(
                    fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                    int(shared_mem)), "cuFuncSetAttribute")
            # kernelParams: one pointer to each argument; ``values`` keeps
            # the arguments alive until the launch returns
            params = (ctypes.c_void_p * len(values))(
                *(ctypes.addressof(v) for v in values))
            stream = torch.cuda.current_stream(index).cuda_stream
            _cu_check(cuda, cuda.cuLaunchKernel(
                fn, *grid, *block, int(shared_mem), ctypes.c_void_p(stream),
                params, None), f"cuLaunchKernel({self.name!r})")
        CudaKernel.launches += 1


def _dims(dims, what):
    dims = (dims,) if isinstance(dims, int) else tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise ValueError(f"{what} must be 1 to 3 positive ints, got {dims}")
    return dims + (1,) * (3 - len(dims))


# ------------------------------------------------------- compile_pallas twin
_THREADS = 256


def compile_cuda(source, kernel_name, out_shape):
    """Compile CUDA source into ``fn(*tensors) -> tensor`` (the counterpart
    of ``mxnet_tpu.rtc.compile_pallas``).

    ``source`` defines ``extern "C" __global__ void kernel_name(const T
    *in0, ..., T *out, long long n)`` over ``n`` output elements;
    ``out_shape`` is ``(shape, dtype)``.  ``fn`` allocates the output on the
    inputs' device and launches ceil(n / 256) blocks of 256 threads on the
    current stream.  Inputs must be contiguous CUDA tensors; the kernel
    guards ``i < n`` itself.
    """
    module = CudaModule(source)
    shape = tuple(int(d) for d in out_shape[0])
    dtype = out_shape[1] if isinstance(out_shape[1], torch.dtype) \
        else getattr(torch, str(np.dtype(out_shape[1])))
    if dtype not in _C_NAME_OF:
        raise TypeError(f"compile_cuda cannot pass {dtype}")
    kernels = {}

    def fn(*tensors):
        for i, t in enumerate(tensors):
            if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
                raise ValueError(f"{kernel_name}: input {i} must be a CUDA "
                                 f"tensor; CUDA source does not run on the "
                                 f"CPU")
        key = tuple(t.dtype for t in tensors)
        kernel = kernels.get(key)
        if kernel is None:
            for t in tensors:
                if t.dtype not in _C_NAME_OF:
                    raise TypeError(f"{kernel_name}: cannot pass {t.dtype}")
            sig = [f"const {_C_NAME_OF[d]} *in{i}" for i, d in enumerate(key)]
            sig += [f"{_C_NAME_OF[dtype]} *out", "int64_t n"]
            kernel = kernels[key] = module.get_kernel(kernel_name,
                                                      ", ".join(sig))
        device = tensors[0].device if tensors else torch.device(
            "cuda", torch.cuda.current_device())
        out = torch.empty(shape, dtype=dtype, device=device)
        n = out.numel()
        if n:
            kernel.launch([*tensors, out, n], device,
                          (math.ceil(n / _THREADS), 1, 1), (_THREADS, 1, 1))
        return out

    fn.module = module
    return fn

