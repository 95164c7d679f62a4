"""``mx.rtc`` on the card: NVRTC-compiled kernels against plain torch.

Marked ``gpu``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package, so on a machine with the card it
runs without them:

    python -m pytest --noconftest -q tests/test_torch_rtc_gpu.py

Every comparison is bitwise: each kernel does the same one or two
correctly rounded operations as the torch expression it is held to
(``--fmad=false`` keeps NVRTC from fusing ``y + alpha * x`` into one FMA,
which rounds once where torch rounds twice).
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc

DOUBLE_K = r'''
extern "C" __global__ void double_k(const float *in0, float *out,
                                    long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = in0[i] * 2.0f;
}
'''

# Apache MXNet's mx.rtc example
AXPY = r'''
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
'''

TEMPLATED = r'''
template <typename T>
__global__ void scale(const T *x, T *y, T a, int n) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    if (i < n) y[i] = x[i] * a;
}
'''

HALF_AND_INT64 = r'''
#include <cuda_fp16.h>
extern "C" __global__ void add_half(const __half *x, __half *y, __half a,
                                    long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) y[i] = __hadd(x[i], a);
}
extern "C" __global__ void iota64(long long *y, long long start,
                                  long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) y[i] = start + i;
}
'''


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a), NVRTC and the driver")
    return torch.device("cuda")


def _randn(shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype("float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128), (3, 1000, 7)])
def test_compile_cuda_double_k_is_twice_x(cuda, shape):
    fn = mx.rtc.compile_cuda(DOUBLE_K, "double_k", (shape, "float32"))
    x = _randn(shape).to(cuda)
    before = rtc.CudaKernel.launches
    out = fn(x)
    torch.cuda.synchronize()
    assert rtc.CudaKernel.launches == before + 1
    assert out.shape == shape and out.dtype == torch.float32
    assert torch.equal(out, x * 2)
    assert fn.module.compile_seconds > 0


@pytest.mark.gpu
def test_reference_axpy_example(cuda):
    module = mx.rtc.CudaModule(AXPY)
    func = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = torch.ones(10, device=cuda)
    y = torch.zeros(10, device=cuda)
    func.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    torch.cuda.synchronize()
    assert y.tolist() == [3.0] * 10


@pytest.mark.gpu
def test_axpy_bitwise_at_resnet_activation_size(cuda):
    module = mx.rtc.CudaModule(AXPY, options=("--fmad=false",))
    func = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = _randn((8, 64, 112, 112), 1).to(cuda)
    y = _randn((8, 64, 112, 112), 2).to(cuda)
    want = y + 0.37 * x
    func.launch([x, y, 0.37], cuda, (x.numel() // 256,), (256,))
    torch.cuda.synchronize()
    assert torch.equal(y, want)


@pytest.mark.gpu
def test_templated_kernels_through_exports(cuda):
    module = mx.rtc.CudaModule(TEMPLATED,
                               exports=("scale<float>", "scale<double>"))
    x = _randn((1000,), 3).to(cuda)
    for dtype, ctype in ((torch.float32, "float"), (torch.float64,
                                                    "double")):
        k = module.get_kernel(f"scale<{ctype}>",
                              f"const {ctype} *x, {ctype} *y, {ctype} a, "
                              f"int n")
        xi = x.to(dtype)
        y = torch.empty_like(xi)
        k.launch([xi, y, 1.5, xi.numel()], cuda, (4,), (256,))
        torch.cuda.synchronize()
        assert torch.equal(y, xi * 1.5)
    with pytest.raises(RuntimeError, match="cuModuleGetFunction"):
        module.get_kernel("scale", "const float *x, float *y, float a, int n")


@pytest.mark.gpu
def test_half_and_int64_arguments(cuda):
    module = mx.rtc.CudaModule(HALF_AND_INT64)
    add = module.get_kernel("add_half", "const __half *x, __half *y, "
                                        "__half a, int64_t n")
    x = _randn((777,), 4).to(cuda, torch.float16)
    y = torch.empty_like(x)
    add.launch([x, y, 0.3, x.numel()], cuda, (4,), (256,))
    iota = module.get_kernel("iota64", "int64_t *y, int64_t start, int64_t n")
    z = torch.empty(500, dtype=torch.int64, device=cuda)
    iota.launch([z, 2 ** 40 + 7, z.numel()], cuda, (2,), (256,))
    torch.cuda.synchronize()
    assert torch.equal(y, x + torch.tensor(0.3, dtype=torch.float16))
    assert torch.equal(z, torch.arange(500, device=cuda) + 2 ** 40 + 7)


@pytest.mark.gpu
def test_compile_and_launch_errors_raise(cuda):
    with pytest.raises(RuntimeError, match="NVRTC failed") as e:
        mx.rtc.CudaModule('extern "C" __global__ void k(float *y) '
                          '{ y[0] = undeclared; }')
    assert "undeclared" in str(e.value)
    func = mx.rtc.CudaModule(AXPY).get_kernel(
        "axpy", "const float *x, float *y, float alpha")
    x = torch.ones(4096, device=cuda)
    with pytest.raises(RuntimeError, match="cuLaunchKernel"):
        func.launch([x, x.clone(), 1.0], cuda, (2,), (2048,))   # > 1024
    with pytest.raises(ValueError, match="CUDA device only"):
        func.launch([x.cpu(), x.cpu(), 1.0], None, (1,), (4,))
    fn = mx.rtc.compile_cuda(DOUBLE_K, "double_k", ((4,), "float32"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(torch.ones(4))


@pytest.mark.gpu
def test_launch_from_a_fresh_thread(cuda):
    """A batcher's worker thread has no current CUDA context of its own;
    the launch makes the device's primary context current."""
    fn = mx.rtc.compile_cuda(DOUBLE_K, "double_k", ((8, 128), "float32"))
    x = _randn((8, 128), 5).to(cuda)
    out = []
    t = threading.Thread(target=lambda: out.append(fn(x)))
    t.start()
    t.join(timeout=60)
    torch.cuda.synchronize()
    assert torch.equal(out[0], x * 2)
