"""Seeded cases for every op in the table, shared by the port's tests and
``chip_smoke.py``.

``OP_CASES`` holds one or more :class:`Case` per canonical op of the
deterministic table (the samplers are held by distribution instead:
``RANDOM_CASES``).  A case names the op, its input arrays as specs that
:func:`make_inputs` turns into seeded numpy arrays, its attributes, whether
its gradient is compared (``grad``: through every float input, for the
first output) and whether its outputs compare exactly (``exact``: integers,
indices, 0/1 masks, shapes).  :func:`run_case` runs one case through
``mx.nd`` on a context and returns numpy outputs (and gradients), so one
case can be held against the JAX package (the CPU tests) and against the
CPU from the card (``tests/test_torch_nd_gpu.py``, ``chip_smoke.py``).

Tolerances (:func:`tolerance`): fp32 rtol 1e-5 and atol 1e-6; fp16 and
bf16 1e-2 relative; exact cases exactly.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np

__all__ = ["Case", "OP_CASES", "RANDOM_CASES", "UPDATE_OPS", "make_inputs",
           "run_case", "compare", "tolerance", "case_id"]


class Case(NamedTuple):
    name: str
    inputs: tuple
    attrs: dict = {}
    grad: bool = True
    exact: bool = False
    dtype: str = "float32"


def _spec_array(spec, rng):
    """``("n", shape)`` normal, ``("u", shape, lo, hi)`` uniform, ``("p",
    shape)`` in [0.5, 2), ``("i", shape, lo, hi)`` integers held as
    float32 (MXNet's index arrays), ``("I", ...)`` the same as int32,
    ``("b", shape)`` 0/1 as float32; a numpy array stands for itself."""
    if isinstance(spec, np.ndarray):
        return spec
    kind, shape = spec[0], spec[1]
    if kind == "n":
        return rng.randn(*shape).astype("float32")
    if kind == "u":
        return rng.uniform(spec[2], spec[3], shape).astype("float32")
    if kind == "p":
        return rng.uniform(0.5, 2.0, shape).astype("float32")
    if kind in ("i", "I"):
        return rng.randint(spec[2], spec[3], shape).astype(
            "float32" if kind == "i" else "int32")
    if kind == "b":
        return (rng.rand(*shape) > 0.5).astype("float32")
    raise ValueError(f"unknown input spec {spec!r}")


def make_inputs(case, seed=0):
    """The case's input arrays, from a generator seeded by its name."""
    rng = np.random.RandomState((zlib.crc32(case.name.encode()) + seed)
                                % 2**31)
    return [_spec_array(s, rng) for s in case.inputs]


def case_id(case):
    """A stable test id: the op and a checksum of its attributes and
    dtype."""
    key = f"{case.attrs!r}{case.dtype}{case.inputs!r}".encode()
    return f"{case.name}-{zlib.crc32(key) % 10**5}"


def tolerance(case):
    """(rtol, atol) of a case's outputs and gradients."""
    if case.exact:
        return 0.0, 0.0
    if case.dtype in ("float16", "bfloat16"):
        return 1e-2, 1e-2
    return 1e-5, 1e-6


def run_case(nd, autograd, case, ctx, seed=0):
    """Run ``case`` through the ``mx.nd`` namespace ``nd`` on ``ctx``:
    ``(outputs, grads, contexts)``, outputs and grads as float64/int numpy
    arrays (grads ``None`` unless ``case.grad``), contexts those of every
    output and gradient array.  Float inputs are cast to ``case.dtype``;
    with ``grad`` the first output is differentiated against a seeded head
    gradient under ``autograd.record()``."""
    arrays = make_inputs(case, seed)
    xs = [nd.array(a, ctx=ctx, dtype=case.dtype if a.dtype == np.float32
                   else a.dtype) for a in arrays]
    fn = getattr(nd, case.name)
    if not case.grad:
        outs = _as_list(fn(*xs, ctx=ctx, **case.attrs))
        return _numpy(outs), None, [o.context for o in outs]
    floats = [x for x, a in zip(xs, arrays) if a.dtype == np.float32]
    for x in floats:
        x.attach_grad()
    with autograd.record():
        outs = _as_list(fn(*xs, ctx=ctx, **case.attrs))
    rng = np.random.RandomState(1)
    hg = nd.array(np.asarray(rng.randn(*outs[0].shape), "float32"), ctx=ctx,
                  dtype=case.dtype)
    outs[0].backward(hg)
    grads = [x.grad for x in floats]
    return _numpy(outs), _numpy(grads), [a.context for a in outs + grads]


def compare(case, got, want, what):
    """Hold ``got`` to ``want`` (lists of numpy arrays) at the case's
    tolerance; returns the largest absolute difference."""
    rtol, atol = tolerance(case)
    assert len(got) == len(want), f"{what}: {len(got)} vs {len(want)}"
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{what} {i}: {g.shape} vs {w.shape}"
        if case.exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {i}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{what} {i}")
        if g.size:
            d = np.abs(g.astype(np.float64) - w.astype(np.float64))
            worst = max(worst, float(np.nan_to_num(d, nan=0.0).max()))
    return worst


def _as_list(outs):
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


def _numpy(arrays):
    out = []
    for a in arrays:
        a = np.asarray(a.asnumpy())
        out.append(a.astype(np.float64) if a.dtype.kind == "f" or
                   str(a.dtype) == "bfloat16" else a)
    return out


# ------------------------------------------------------------------ cases
S = (3, 4)
S3 = (2, 3, 4)


def _unary(names, spec=("n", S), grad=True, exact=False):
    return [Case(n, (spec,), grad=grad, exact=exact) for n in names]


OP_CASES = []
OP_CASES += _unary(["abs", "sign", "round", "rint", "ceil", "floor",
                    "trunc", "fix", "square", "cbrt", "exp", "expm1", "sin",
                    "cos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
                    "degrees", "radians", "negative", "sigmoid", "softsign",
                    "relu", "erf", "softplus", "_copy", "_copyto",
                    "make_loss", "hard_sigmoid"])
OP_CASES += [Case("round", (np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.2],
                                     "float32"),), exact=True),
             Case("rint", (np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5],
                                    "float32"),), exact=True)]
OP_CASES += _unary(["sqrt", "rsqrt", "rcbrt", "log", "log10", "log2",
                    "log1p", "reciprocal", "gammaln", "gamma", "digamma"],
                   spec=("p", S))
OP_CASES += _unary(["tan"], spec=("u", S, -1.0, 1.0))
OP_CASES += _unary(["arcsin", "arccos", "arctanh", "erfinv"],
                   spec=("u", S, -0.9, 0.9))
OP_CASES += _unary(["arccosh"], spec=("u", S, 1.2, 3.0))
OP_CASES += _unary(["logical_not"], spec=("i", S, -1, 2), grad=False,
                   exact=True)
OP_CASES += _unary(["isnan", "isinf", "isfinite"],
                   spec=np.array([0.0, np.nan, np.inf, -np.inf, 1.5],
                                 "float32"), grad=False, exact=True)
OP_CASES += _unary(["size_array", "shape_array", "zeros_like", "ones_like",
                    "BlockGrad"], grad=False, exact=True)
OP_CASES += [Case("abs", (("I", S, -5, 5),), grad=False, exact=True),
             Case("exp", (("n", S),), dtype="float16"),
             Case("tanh", (("n", S),), dtype="bfloat16"),
             Case("clip", (("n", S),), {"a_min": -0.5, "a_max": 0.5})]
OP_CASES += [Case("LeakyReLU", (("n", S),), {"act_type": t})
             for t in ("leaky", "elu", "selu", "gelu", "rrelu")]
OP_CASES += [Case("LeakyReLU", (("n", (2, 3, 4)), ("p", (3,))),
                  {"act_type": "prelu"})]
OP_CASES += [Case("Activation", (("n", S),), {"act_type": t})
             for t in ("relu", "sigmoid", "tanh", "softrelu", "softsign")]
# SoftmaxOutput's gradient ignores the head gradient (two cases here, two
# after ``softmax``: each half of the table keeps its earlier cases)
OP_CASES += [Case("SoftmaxOutput", (("n", (4, 5)), ("i", (4,), 0, 5))),
             Case("SoftmaxOutput", (("n", (2, 3, 4)), ("i", (2, 4), 0, 3)),
                  {"multi_output": True, "grad_scale": 0.5})]

_BIN = ["elemwise_add", "elemwise_sub", "elemwise_mul", "_maximum",
        "_minimum", "_hypot", "_grad_add"]
OP_CASES += [Case(n, (("n", S), ("n", S))) for n in _BIN]
OP_CASES += [Case(n, (("n", S), ("p", S)))
             for n in ("elemwise_div", "_scatter_elemwise_div")]
OP_CASES += [Case(n, (("p", S), ("n", S))) for n in ("_power",)]
OP_CASES += [Case("_mod", (("u", S, -3.0, 3.0), ("p", S)))]
OP_CASES += [Case(n, (("i", S, 0, 3), ("i", S, 0, 3)), grad=False,
                  exact=True)
             for n in ("_equal", "_not_equal", "_greater", "_greater_equal",
                       "_lesser", "_lesser_equal", "_logical_and",
                       "_logical_or", "_logical_xor")]
OP_CASES += [Case("add_n", (("n", S), ("n", S), ("n", S))),
             Case("elemwise_add", (("I", S, -9, 9), ("I", S, -9, 9)),
                  grad=False, exact=True),
             Case("elemwise_mul", (("n", S), ("n", S)), dtype="float16")]

_SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
           "_div_scalar", "_maximum_scalar", "_minimum_scalar",
           "_hypot_scalar", "_scatter_plus_scalar", "_scatter_minus_scalar",
           "smooth_l1"]
OP_CASES += [Case(n, (("n", S),), {"scalar": 0.7}) for n in _SCALAR]
OP_CASES += [Case(n, (("p", S),), {"scalar": 1.3})
             for n in ("_rdiv_scalar", "_power_scalar", "_rpower_scalar",
                       "_mod_scalar", "_rmod_scalar")]
OP_CASES += [Case(n, (("i", S, -2, 3),), {"scalar": 1.0}, grad=False,
                  exact=True)
             for n in ("_equal_scalar", "_not_equal_scalar",
                       "_greater_scalar", "_greater_equal_scalar",
                       "_lesser_scalar", "_lesser_equal_scalar",
                       "_logical_and_scalar", "_logical_or_scalar",
                       "_logical_xor_scalar")]
OP_CASES += [Case("_plus_scalar", (("I", S, -5, 5),), {"scalar": 2.5},
                  grad=False, exact=True)]
OP_CASES += [Case("cast", (("n", S),), {"dtype": "float16"}, grad=False),
             Case("cast", (("u", S, -9, 9),), {"dtype": "int32"},
                  grad=False, exact=True),
             Case("amp_cast", (("n", S),), {"dtype": "float16"}, grad=False),
             Case("amp_multicast", (("n", S), ("n", S)), {"num_outputs": 2}),
             Case("where", (("b", S), ("n", S), ("n", S))),
             Case("where", (("b", (3,)), ("n", S), ("n", S)))]
OP_CASES += [Case(n, (("I", S, 0, 16), ("I", S, 0, 16)), grad=False,
                  exact=True)
             for n in ("_contrib_bitwise_and", "_contrib_bitwise_or",
                       "_contrib_bitwise_xor")]

# broadcast and reduce
_BB = (("n", S3), ("n", (1, 3, 1)))
OP_CASES += [Case(n, _BB) for n in (
    "broadcast_add", "broadcast_plus", "broadcast_sub", "broadcast_minus",
    "broadcast_mul", "broadcast_maximum", "broadcast_minimum",
    "broadcast_hypot")]
OP_CASES += [Case("broadcast_div", (("n", S3), ("p", (1, 3, 1)))),
             Case("broadcast_mod", (("u", S3, -3, 3), ("p", (1, 3, 1)))),
             Case("broadcast_power", (("p", S3), ("n", (1, 3, 1))))]
OP_CASES += [Case(n, (("i", S3, 0, 3), ("i", (1, 3, 1), 0, 3)), grad=False,
                  exact=True)
             for n in ("broadcast_equal", "broadcast_not_equal",
                       "broadcast_greater", "broadcast_greater_equal",
                       "broadcast_lesser", "broadcast_lesser_equal",
                       "broadcast_logical_and", "broadcast_logical_or",
                       "broadcast_logical_xor")]
OP_CASES += [Case("broadcast_like", (("n", (1, 3, 1)), ("n", S3))),
             Case("broadcast_to", (("n", (1, 3, 1)),), {"shape": (2, 0, 4)}),
             Case("broadcast_axis", (("n", (1, 3, 1)),),
                  {"axis": (0, 2), "size": (2, 4)})]
OP_CASES += [Case(n, (("n", S3),), {"axis": (0, 2), "keepdims": True})
             for n in ("sum", "nansum", "mean", "prod", "nanprod", "max",
                       "min", "sum_axis", "_square_sum")]
OP_CASES += [Case("sum", (("n", S3),)),
             Case("sum", (("n", S3),), {"axis": 1, "exclude": True}),
             Case("sum", (("I", S3, -5, 5),), {"axis": 1}, grad=False,
                  exact=True),
             Case("mean", (("n", S3),), {"axis": -1}, dtype="float16"),
             Case("nansum", (np.array([[1.0, np.nan], [2.0, 3.0]],
                                      "float32"),), {"axis": 1},
                  grad=False),
             Case("norm", (("n", S3),)),
             Case("norm", (("n", S3),), {"ord": 1, "axis": 1}),
             Case("argmax", (("n", S3),), {"axis": 1}, grad=False,
                  exact=True),
             Case("argmin", (("n", S3),), {"axis": 2, "keepdims": True},
                  grad=False, exact=True),
             Case("argmax", (("n", S3),), grad=False, exact=True),
             Case("argmax_channel", (("n", S),), grad=False, exact=True),
             Case("pick", (("n", S), ("i", (3,), 0, 4)), {"axis": 1}),
             Case("pick", (("n", S), ("i", (4,), 0, 3)),
                  {"axis": 0, "keepdims": True}),
             Case("moments", (("n", S3),), {"axes": (0, 2)})]

# shape, slicing, indexing, products, ordering
OP_CASES += [Case("reshape", (("n", S3),), {"shape": s}) for s in
             ((4, -1), (0, -1), (-3, 0), (-4, 1, 2, -2), (-1,), (0, 0, -2))]
OP_CASES += [Case("reshape", (("n", S3),), {"shape": (-1, 0),
                                            "reverse": True}),
             Case("reshape", (("n", S3),), {"target_shape": (0, 4)}),
             Case("reshape_like", (("n", S3), ("n", (4, 6)))),
             Case("Flatten", (("n", S3),)),
             Case("transpose", (("n", S3),)),
             Case("transpose", (("n", S3),), {"axes": (1, 0, 2)}),
             Case("expand_dims", (("n", S),), {"axis": 1}),
             Case("expand_dims", (("n", S),), {"axis": -1}),
             Case("squeeze", (("n", (2, 1, 3, 1)),)),
             Case("squeeze", (("n", (2, 1, 3, 1)),), {"axis": 1}),
             Case("swapaxes", (("n", S3),), {"dim1": 0, "dim2": 2}),
             Case("depth_to_space", (("n", (1, 8, 2, 3)),),
                  {"block_size": 2}),
             Case("space_to_depth", (("n", (1, 2, 4, 6)),),
                  {"block_size": 2}),
             Case("slice", (("n", S3),), {"begin": (0, 1), "end": (2, 3)}),
             Case("slice", (("n", S3),), {"begin": (None, None, 3),
                                          "end": (None, None, 0),
                                          "step": (1, 2, -1)}),
             Case("_slice_assign", (("n", S), ("n", (2, 2))),
                  {"begin": (0, 1), "end": (2, 3)}),
             Case("_slice_assign", (("n", S), ("n", (3, 2))),
                  {"begin": (None, 3), "end": (None, None),
                   "step": (1, -2)}),
             Case("_slice_assign_scalar", (("n", S),),
                  {"scalar": 5.0, "begin": (1, 0), "end": (3, 4),
                   "step": (1, 2)}),
             Case("slice_axis", (("n", S3),),
                  {"axis": 1, "begin": 1, "end": 3}),
             Case("slice_axis", (("n", S3),),
                  {"axis": -1, "begin": -3, "end": None}),
             Case("slice_like", (("n", S3), ("n", (2, 2, 3)))),
             Case("slice_like", (("n", S3), ("n", (1, 2, 3))),
                  {"axes": (1,)}),
             Case("Concat", (("n", S3), ("n", S3)), {"dim": 1}),
             Case("Concat", (("n", S3), ("n", (2, 3, 2))), {"dim": -1}),
             Case("stack", (("n", S), ("n", S)), {"axis": 1}),
             Case("split", (("n", (2, 4, 3)),), {"num_outputs": 2,
                                                 "axis": 1}),
             Case("split", (("n", (2, 4, 3)),),
                  {"num_outputs": 2, "axis": 0, "squeeze_axis": True}),
             Case("split_v2", (("n", (2, 6, 3)),),
                  {"indices_or_sections": (1, 4), "axis": 1}),
             Case("split_v2", (("n", (2, 6, 3)),),
                  {"indices_or_sections": 3, "axis": 1}),
             Case("tile", (("n", S),), {"reps": (2, 1, 3)}),
             Case("repeat", (("n", S),), {"repeats": 2, "axis": 1}),
             Case("repeat", (("n", S),), {"repeats": 2}),
             Case("reverse", (("n", S3),), {"axis": (0, 2)}),
             Case("Pad", (("n", (2, 3, 4, 5)),),
                  {"mode": "constant", "pad_width": (0, 0, 1, 0, 1, 2, 2, 1),
                   "constant_value": 0.5}),
             Case("Pad", (("n", (2, 3, 4, 5)),),
                  {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
             Case("Pad", (("n", (2, 3, 4, 5)),),
                  {"mode": "reflect",
                   "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
             Case("take", (("n", (5, 3)), ("i", (2, 3), 0, 5))),
             Case("take", (("n", (5, 3)), ("i", (4,), -3, 9)),
                  {"axis": 0, "mode": "wrap"}),
             Case("take", (("n", (3, 5)), ("i", (4,), -3, 9)), {"axis": 1}),
             Case("batch_take", (("n", (4, 5)), ("i", (4,), 0, 5))),
             Case("Embedding", (("i", (2, 3), 0, 10), ("n", (10, 4))),
                  {"input_dim": 10, "output_dim": 4}),
             Case("one_hot", (("i", (4,), 0, 5),), {"depth": 5},
                  grad=False, exact=True),
             Case("one_hot", (("i", (2, 3), -1, 6),),
                  {"depth": 5, "on_value": 2.0, "off_value": -1.0},
                  grad=False, exact=True),
             Case("gather_nd", (("n", S), np.array(
                 [[0, 1, 2, 0, 2], [0, 1, 2, 3, 1]], "float32"))),
             Case("scatter_nd", (("n", (5,)), np.array(
                 [[0, 1, 2, 0, 2], [0, 1, 2, 3, 1]], "float32")),
                  {"shape": S}),
             Case("_scatter_set_nd", (("n", S), ("n", (5,)), np.array(
                 [[0, 1, 2, 0, 2], [0, 1, 2, 3, 1]], "float32")),
                  {"shape": S}),
             Case("_backward_gather_nd", (("n", (5,)), np.array(
                 [[0, 1, 0, 0, 2], [0, 1, 0, 3, 1]], "float32")),
                  {"shape": S}),
             # the JAX package cannot differentiate its dynamic shape
             Case("boolean_mask", (("n", S), np.array([1, 0, 1], "float32")),
                  grad=False),
             Case("dot", (("n", S), ("n", (4, 5)))),
             Case("dot", (("n", S), ("n", (5, 4))), {"transpose_b": True}),
             Case("dot", (("n", (4,)), ("n", (4,)))),
             Case("dot", (("n", S3), ("n", (4, 2)))),
             Case("batch_dot", (("n", S3), ("n", (2, 4, 5)))),
             Case("batch_dot", (("n", (2, 4, 3)), ("n", (2, 4, 5))),
                  {"transpose_a": True}),
             Case("khatri_rao", (("n", (3, 2)), ("n", (4, 2)))),
             Case("sort", (("n", S3),)),
             Case("sort", (("n", S3),), {"axis": 1, "is_ascend": False}),
             Case("argsort", (("n", S3),), grad=False, exact=True),
             Case("argsort", (np.array([[1, 0, 1, 0, 2]], "float32"),),
                  {"is_ascend": False}, grad=False, exact=True),
             Case("topk", (("n", S3),), {"k": 2}, grad=False, exact=True),
             Case("topk", (np.array([[3, 1, 3, 2, 1]], "float32"),),
                  {"k": 3, "is_ascend": True}, grad=False, exact=True),
             Case("topk", (("n", S3),), {"k": 2, "axis": 1,
                                         "ret_typ": "value"}),
             Case("topk", (("n", S3),), {"k": 2, "ret_typ": "both"}),
             Case("topk", (("n", S3),), {"k": 2, "ret_typ": "mask"},
                  grad=False, exact=True),
             Case("diag", (("n", (4,)),), {"k": 1}),
             Case("diag", (("n", S),), {"k": -1}),
             Case("histogram", (("n", (50,)),),
                  {"bin_cnt": 5, "range": (-2.0, 2.0)}, grad=False),
             Case("ravel_multi_index", (np.array([[0, 1, 2, 2], [3, 0, 1, 2]],
                                                 "float32"),),
                  {"shape": S}, grad=False, exact=True),
             Case("unravel_index", (np.array([0, 5, 11, 7], "float32"),),
                  {"shape": S}, grad=False, exact=True),
             Case("SequenceMask", (("n", (4, 2, 3)),
                                   np.array([2, 3], "float32")),
                  {"use_sequence_length": True, "value": -1.0}),
             Case("SequenceLast", (("n", (4, 2, 3)),
                                   np.array([2, 3], "float32")),
                  {"use_sequence_length": True}),
             Case("SequenceLast", (("n", (4, 2, 3)),)),
             Case("SequenceReverse", (("n", (4, 2, 3)),
                                      np.array([2, 4], "float32")),
                  {"use_sequence_length": True}),
             Case("SequenceReverse", (("n", (2, 4, 3)),
                                      np.array([2, 4], "float32")),
                  {"use_sequence_length": True, "axis": 1})]

# creation
OP_CASES += [Case("_zeros", (), {"shape": S}, grad=False, exact=True),
             Case("_ones", (), {"shape": S, "dtype": "int32"}, grad=False,
                  exact=True),
             Case("_full", (), {"shape": S, "value": 2.5}, grad=False),
             Case("_arange", (), {"start": 1, "stop": 7, "step": 1.5},
                  grad=False),
             Case("_arange", (), {"start": 4, "repeat": 2}, grad=False),
             Case("_linspace", (), {"start": 0, "stop": 1, "num": 5,
                                    "endpoint": False}, grad=False),
             Case("_eye", (), {"N": 3, "M": 4, "k": 1}, grad=False,
                  exact=True)]

# layer ops (registered from ops/nn.py) and flash attention
OP_CASES += [
    Case("FullyConnected", (("n", (2, 5)), ("n", (3, 5)), ("n", (3,))),
         {"num_hidden": 3}),
    Case("FullyConnected", (("n", (2, 3, 5)), ("n", (4, 5))),
         {"num_hidden": 4, "no_bias": True, "flatten": False}),
    Case("Convolution", (("n", (2, 3, 6, 6)), ("n", (4, 3, 3, 3)),
                         ("n", (4,))),
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4}),
    Case("Convolution", (("n", (2, 4, 6, 6)), ("n", (4, 2, 3, 3))),
         {"kernel": (3, 3), "stride": (2, 2), "num_filter": 4,
          "num_group": 2, "no_bias": True}),
    Case("Pooling", (("n", (2, 3, 6, 6)),),
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"}),
    Case("Pooling", (("n", (2, 3, 7, 7)),),
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "pool_type": "avg", "pooling_convention": "full"}),
    Case("Pooling", (("n", (2, 3, 6, 6)),),
         {"kernel": (3, 3), "stride": (2, 2), "pool_type": "avg",
          "count_include_pad": False, "pad": (1, 1)}),
    Case("Pooling", (("n", (2, 3, 6, 6)),),
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": "lp",
          "p_value": 2}),
    Case("Pooling", (("n", (2, 3, 6, 6)),),
         {"global_pool": True, "pool_type": "avg", "kernel": (1, 1)}),
    Case("BatchNorm", (("n", (2, 3, 4, 4)), ("p", (3,)), ("n", (3,)),
                       ("n", (3,)), ("p", (3,))), {"fix_gamma": False}),
    Case("LayerNorm", (("n", S3), ("p", (4,)), ("n", (4,)))),
    Case("LayerNorm", (("n", S3), ("p", (3,)), ("n", (3,))), {"axis": 1}),
    Case("softmax", (("n", S3),), {"axis": 1}),
    Case("softmax", (("n", S3),), {"temperature": 2.0}),
    Case("softmax", (("n", S3),), {}, dtype="float16"),
    Case("log_softmax", (("n", S3),)),
    Case("softmin", (("n", S3),), {"axis": 0}),
    Case("SoftmaxOutput", (("n", (6, 5)), ("i", (6,), 0, 3)),
         {"use_ignore": True, "ignore_label": 1, "normalization": "valid"}),
    Case("Softmax", (("n", (4, 5)), ("i", (4,), 0, 5)),
         {"normalization": "batch"}),
    Case("Dropout", (("n", S3),), {"p": 0.5}, grad=False),
    Case("_contrib_flash_attention", (("n", (2, 2, 16, 8)),
                                      ("n", (2, 2, 16, 8)),
                                      ("n", (2, 2, 16, 8)))),
    Case("_contrib_flash_attention", (("n", (1, 2, 20, 8)),
                                      ("n", (1, 2, 20, 8)),
                                      ("n", (1, 2, 20, 8))),
         {"causal": True, "scale": 0.5}),
]

# the update ops write their inputs: the test compares the inputs after
UPDATE_OPS = [
    Case("sgd_update", (("n", S), ("n", S)), {"lr": 0.1, "wd": 0.01},
         grad=False),
    Case("sgd_mom_update", (("n", S), ("n", S), ("n", S)),
         {"lr": 0.1, "momentum": 0.9, "wd": 0.01, "rescale_grad": 0.5,
          "clip_gradient": 0.8}, grad=False),
    Case("adam_update", (("n", S), ("n", S), ("n", S), ("p", S)),
         {"lr": 0.01, "beta1": 0.8, "beta2": 0.9, "epsilon": 1e-6,
          "wd": 0.1}, grad=False),
]

# samplers: (op, inputs, attrs, mean, variance) of the drawn distribution;
# n draws each (the tests' 100k), held within 5 standard errors
RANDOM_CASES = [
    ("_random_uniform", (), {"low": -1.0, "high": 3.0}, 1.0, 16 / 12),
    ("_random_normal", (), {"loc": 1.0, "scale": 2.0}, 1.0, 4.0),
    ("_random_gamma", (), {"alpha": 2.0, "beta": 1.5}, 3.0, 4.5),
    ("_random_exponential", (), {"lam": 4.0}, 0.25, 1 / 16),
    ("_random_poisson", (), {"lam": 3.0}, 3.0, 3.0),
    ("_random_negative_binomial", (), {"k": 3, "p": 0.4}, 4.5, 11.25),
    ("_random_generalized_negative_binomial", (), {"mu": 2.0, "alpha": 0.5},
     2.0, 4.0),
    ("_random_randint", (), {"low": -2, "high": 5}, 1.0, 4.0),
    ("_random_bernoulli", (), {"p": 0.3}, 0.3, 0.21),
    ("_sample_uniform", (np.array([0.0], "float32"),
                         np.array([2.0], "float32")), {}, 1.0, 1 / 3),
    ("_sample_normal", (np.array([-1.0], "float32"),
                        np.array([0.5], "float32")), {}, -1.0, 0.25),
    ("_sample_gamma", (np.array([3.0], "float32"),
                       np.array([0.5], "float32")), {}, 1.5, 0.75),
    ("_sample_poisson", (np.array([5.0], "float32"),), {}, 5.0, 5.0),
    ("_sample_exponential", (np.array([2.0], "float32"),), {}, 0.5, 0.25),
    ("_sample_negative_binomial", (np.array([2.0], "float32"),
                                   np.array([0.5], "float32")), {}, 2.0,
     4.0),
    ("_sample_generalized_negative_binomial",
     (np.array([3.0], "float32"), np.array([0.25], "float32")), {}, 3.0,
     5.25),
    ("_sample_multinomial", (np.array([[0.2, 0.5, 0.3]], "float32"),), {},
     1.1, 0.49),
]

# AMP's overflow scans (one output, 1.0 when every input is finite); one in
# each half of the list, so that no earlier case moves between the two
# test files that split it
OP_CASES.insert(len(OP_CASES) // 2, Case(
    "all_finite", (("n", S), ("n", (5,)), ("n", S3)), grad=False,
    exact=True))
OP_CASES.append(Case("multi_all_finite", (("n", S), ("n", (5,))),
                     {"num_arrays": 2}, grad=False, exact=True))
UPDATE_OPS += [
    Case("mp_sgd_update", (("n", S), ("n", S), ("n", S)),
         {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}, grad=False),
    Case("mp_sgd_mom_update", (("n", S), ("n", S), ("n", S), ("n", S)),
         {"lr": 0.1, "momentum": 0.9, "wd": 0.01, "clip_gradient": 0.8},
         grad=False),
]
# slice 10: CTCLoss, again one case in each half, and the other update ops
OP_CASES.insert(len(OP_CASES) // 2, Case(
    "CTCLoss", (("n", (8, 3, 5)), ("I", (3, 3), 1, 5))))
OP_CASES.append(Case(
    "CTCLoss", (("n", (8, 3, 5)), ("I", (3, 3), 0, 4), ("I", (3,), 4, 9),
                ("I", (3,), 1, 4)),
    {"use_data_lengths": True, "use_label_lengths": True,
     "blank_label": "last"}))
UPDATE_OPS += [
    Case("nag_mom_update", (("n", S), ("n", S), ("n", S)),
         {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, grad=False),
    Case("rmsprop_update", (("n", S), ("n", S), ("p", S)),
         {"lr": 0.01, "gamma1": 0.9, "wd": 0.01, "clip_weights": 2.0},
         grad=False),
    Case("rmspropalex_update", (("n", S), ("n", S), ("p", S),
                                ("u", S, -0.1, 0.1), ("n", S)),
         {"lr": 0.01, "gamma1": 0.9, "gamma2": 0.8}, grad=False),
    Case("ftrl_update", (("n", S), ("n", S), ("n", S), ("p", S)),
         {"lr": 0.1, "lamda1": 0.02, "beta": 0.5, "wd": 0.01}, grad=False),
    Case("signsgd_update", (("n", S), ("n", S)), {"lr": 0.1, "wd": 0.01},
         grad=False),
    Case("signum_update", (("n", S), ("n", S), ("n", S)),
         {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}, grad=False),
    Case("ftml_update", (("n", S), ("n", S), ("n", S), ("p", S), ("n", S)),
         {"lr": 0.01, "t": 2, "wd": 0.01}, grad=False),
    Case("_sparse_adagrad_update", (("n", S), ("n", S), ("p", S)),
         {"lr": 0.1, "wd": 0.01}, grad=False),
    Case("adamw_update", (("n", S), ("n", S), ("n", S), ("p", S)),
         {"lr": 0.01, "eta": 0.5, "wd": 0.1, "rescale_grad": 0.5},
         grad=False),
]
