"""``mx.rtc`` of the port on the CPU: what runs before any CUDA call.

Signature parsing and launch-argument checks run here; compiling and
launching need NVRTC, the driver and a card (``test_torch_rtc_gpu.py``).
The JAX package's ``compile_pallas`` runs ``double_k`` in interpret mode
and gives ``2 * x``, the figure the card-side test asks of ``compile_cuda``.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.ops import _build


def test_signature_parsing():
    assert rtc.parse_signature("const float *x, float *y, float alpha") == \
        [(True, True, "float"), (True, False, "float"),
         (False, False, "float")]
    assert rtc.parse_signature("const __half*a,int64_t  n, int8_t *q") == \
        [(True, True, "__half"), (False, False, "int64_t"),
         (True, False, "int8_t")]
    assert rtc.parse_signature("double *, uint8_t") == \
        [(True, False, "double"), (False, False, "uint8_t")]
    for bad in ("float x y", "const *x", "float **x", ""):
        with pytest.raises(ValueError, match="invalid kernel argument"):
            rtc.parse_signature(bad)
    with pytest.raises(TypeError, match="unsupported argument type"):
        rtc.parse_signature("const bool *mask")


def _kernel(signature):
    """A kernel of a module that was never compiled: enough to check the
    arguments, which ``launch`` does before it touches the driver."""
    return rtc.CudaKernel(object.__new__(rtc.CudaModule), "axpy", signature)


def test_launch_checks_arguments_before_the_driver():
    k = _kernel("const float *x, float *y, float alpha")
    x, y = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="takes 3 arguments, got 2"):
        k.launch([x, y], None, (1,), (4,))
    with pytest.raises(TypeError, match="float pointer, got a torch.float64"):
        k.launch([x, y.double(), 3.0], None, (1,), (4,))
    with pytest.raises(TypeError, match="pass a tensor"):
        k.launch([x, 1.0, 3.0], None, (1,), (4,))
    with pytest.raises(TypeError, match="pass a number"):
        k.launch([x, y, torch.tensor(3.0)], None, (1,), (4,))
    with pytest.raises(ValueError, match="contiguous"):
        k.launch([torch.ones(4, 2).t(), y, 3.0], None, (1,), (4,))
    # a CPU tensor is refused: CUDA source has no CPU interpreter
    with pytest.raises(ValueError, match="CUDA device only"):
        k.launch([x, y, 3.0], None, (1,), (4,))
    with pytest.raises(ValueError, match="CUDA device only"):
        k.launch([x, y, 3.0], mx.cpu(), (1,), (4,))
    ki = _kernel("int *y, int64_t n")
    with pytest.raises(TypeError, match="int64_t, got 2.5"):
        ki.launch([torch.zeros(2, dtype=torch.int32), 2.5], None, 1, 2)
    with pytest.raises(TypeError, match="a CudaKernel comes from"):
        rtc.CudaKernel(object(), "k", "float *x")
    assert rtc._dims(4, "grid") == (4, 1, 1)
    assert rtc._dims((2, 3), "grid") == (2, 3, 1)
    for bad in ((0, 1), (1, 1, 1, 1)):
        with pytest.raises(ValueError, match="positive ints"):
            rtc._dims(bad, "block_dims")


def test_launch_takes_ndarrays():
    """NDArray arguments go through the same checks as tensors: their
    tensor is what is packed and placed."""
    k = _kernel("const float *x, float *y, float alpha")
    x = mx.nd.ones((4,), ctx=mx.cpu())
    y = mx.nd.zeros((4,), ctx=mx.cpu())
    with pytest.raises(ValueError, match="CUDA device only"):
        k.launch([x, y, 3.0], None, (1,), (4,))
    with pytest.raises(TypeError, match="float pointer, got a torch.int32"):
        k.launch([x, y.astype("int32"), 3.0], None, (1,), (4,))
    with pytest.raises(ValueError, match="takes 3 arguments, got 2"):
        k.launch([x, y], None, (1,), (4,))
    values = k._pack([x.data, y.data, 3.0])
    assert values[0].value == x.data.data_ptr()


def test_scalar_arguments_pack_to_their_c_types():
    k = _kernel("__half h, int8_t c, uint8_t u, int64_t n, double d")
    values = k._pack([1.5, -3, 200, 2 ** 40 + 1, 0.1])
    assert [type(v) for v in values] == [ctypes.c_uint16, ctypes.c_int8,
                                         ctypes.c_uint8, ctypes.c_int64,
                                         ctypes.c_double]
    assert values[0].value == int(np.float16(1.5).view(np.uint16))
    assert [v.value for v in values[1:]] == [-3, 200, 2 ** 40 + 1, 0.1]


@pytest.fixture
def no_toolkit(monkeypatch):
    monkeypatch.setattr(rtc._Lib, "nvrtc", None)
    monkeypatch.setattr(rtc._Lib, "cuda", None)

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", missing)


def test_cuda_module_names_the_missing_nvrtc(no_toolkit):
    with pytest.raises(RuntimeError, match=r"NVRTC \(libnvrtc.so\)"):
        mx.rtc.CudaModule('extern "C" __global__ void k() {}')
    with pytest.raises(RuntimeError, match=r"NVRTC \(libnvrtc.so\)"):
        mx.rtc.compile_cuda("", "double_k", ((8, 128), "float32"))


def test_missing_driver_is_named(monkeypatch):
    def cdll(name, *a, **kw):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(rtc.ctypes, "CDLL", cdll)
    with pytest.raises(RuntimeError, match=r"CUDA driver \(libcuda.so.1\)"):
        rtc._bind_driver()


def test_compile_pallas_double_k_is_twice_x():
    """The JAX function the card-side ``compile_cuda`` test stands in for:
    ``double_k`` on an (8, 128) fp32 array, in Pallas interpret mode."""
    src = "def double_k(x_ref, o_ref):\n    o_ref[:] = x_ref[:] * 2.0\n"
    fn = jmx.rtc.compile_pallas(src, "double_k", ((8, 128), "float32"))
    x = np.random.RandomState(0).randn(8, 128).astype("float32")
    np.testing.assert_array_equal(np.asarray(fn(jnp.asarray(x))), 2 * x)
    # the plain torch expression the CUDA kernel is held to bitwise
    np.testing.assert_array_equal((torch.from_numpy(x) * 2).numpy(), 2 * x)
