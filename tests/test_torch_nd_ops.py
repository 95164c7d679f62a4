"""Every deterministic op of the port's table against the JAX package, on
the CPU: the same seeded numpy inputs through ``mxnet_tpu.nd.<op>`` and
``mxnet_tpu_torch.nd.<op>(ctx=mx.cpu())``, outputs and, for the
differentiable cases, the gradients of every float input under
``autograd.record()`` + ``backward`` (``mxnet_tpu_torch/test_utils.py``
holds the cases and the tolerances: fp32 rtol 1e-5 / atol 1e-6, fp16 and
bf16 1e-2 relative, integer, boolean, shape and index outputs exact).

Values are compared, not dtypes, where the two packages' widths differ by
design: the JAX package runs without x64 (int64 becomes int32), the port
keeps int64 (``size_array``, ``shape_array``).  ``test_dtype_differences``
records each one.

The cases are split across this file and ``test_torch_nd_ops2.py`` by
position, so that xdist balances them.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.test_utils import (OP_CASES, UPDATE_OPS, case_id,
                                        compare, make_inputs, run_case)

HALF = len(OP_CASES) // 2

# where the port's dtype differs from the JAX package's, by design
DTYPE_DIFFERENCES = {"size_array": ("int64", "int32"),
                     "shape_array": ("int64", "int32")}


def check_case(case):
    """One case in both packages: outputs, then gradients."""
    got, ggot, _ = run_case(mx.nd, mx.autograd, case, mx.cpu())
    want, gwant, _ = run_case(jmx.nd, jmx.autograd, case, jmx.cpu())
    compare(case, got, want, f"{case.name} output")
    if case.grad:
        compare(case, ggot, gwant, f"{case.name} gradient")


@pytest.mark.parametrize("case", OP_CASES[:HALF], ids=case_id)
def test_op_matches_jax(case):
    check_case(case)


@pytest.mark.parametrize("case", UPDATE_OPS, ids=case_id)
def test_update_op_writes_like_jax(case):
    """The update ops write the weight (and states) in place and return
    the weight; the JAX package rebinds the same handles."""
    arrays = make_inputs(case)
    ours = [mx.nd.array(a, ctx=mx.cpu()) for a in arrays]
    theirs = [jmx.nd.array(a) for a in arrays]
    tensors = [x.data for x in ours]
    out = getattr(mx.nd, case.name)(*ours, out=ours[0], **case.attrs)
    getattr(jmx.nd, case.name)(*theirs, out=theirs[0], **case.attrs)
    assert out is ours[0]
    for i, (o, t, tensor) in enumerate(zip(ours, theirs, tensors)):
        assert o.data is tensor, f"input {i} was rebound, not written"
        np.testing.assert_allclose(o.asnumpy(), t.asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"input {i}")


def test_dtype_differences():
    x = np.zeros((2, 3), "float32")
    for name, (port, jax_dt) in DTYPE_DIFFERENCES.items():
        assert str(getattr(mx.nd, name)(mx.nd.array(x, ctx=mx.cpu()))
                   .dtype) == port
        assert str(getattr(jmx.nd, name)(jmx.nd.array(x)).dtype) == jax_dt
    # int64 input: kept by the port, made int32 by the JAX package
    big = np.array([2**40, 3], "int64")
    assert mx.nd.array(big, ctx=mx.cpu()).dtype == np.int64
    assert mx.nd.array(big, ctx=mx.cpu()).asnumpy()[0] == 2**40
    assert jmx.nd.array(np.array([5, 3], "int64")).dtype == np.int32
