"""The second half of ``OP_CASES`` against the JAX package (see
``test_torch_nd_ops.py``)."""
import pytest

from mxnet_tpu_torch.test_utils import OP_CASES, case_id

from test_torch_nd_ops import HALF, check_case


@pytest.mark.parametrize("case", OP_CASES[HALF:], ids=case_id)
def test_op_matches_jax(case):
    check_case(case)
