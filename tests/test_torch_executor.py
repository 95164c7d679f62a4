"""The port's Executor against the JAX package's, on the CPU.

``simple_bind``/``bind``, forward and backward with ``grad_req``
``'write'``/``'add'``/``'null'`` per argument, BatchNorm's auxiliary
updates in training (and none in inference), ``SoftmaxOutput``'s gradient
options, the binary-op bind matrix of ``tests/test_executor_api.py``,
``copy_params_from`` and the monitor callback.  fp32 throughout; outputs,
gradients and auxiliary states within 1e-5 of each tensor's largest
magnitude (the packages differ in summation order only).  One exception:
the bias of a convolution that feeds a BatchNorm has a zero gradient in
exact arithmetic (the normalisation removes any shift), so each package's
is rounding noise; it is held within 1e-5 of the convolution weight's
gradient instead.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

TOL = 1e-5


def _net(sym, fix_gamma=False, head="softmax", **head_attrs):
    data = sym.Variable("data")
    c = sym.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                        name="conv")
    b = sym.BatchNorm(c, fix_gamma=fix_gamma, momentum=0.8, name="bn")
    h = sym.Activation(b, act_type="relu", name="relu")
    f = sym.FullyConnected(h, num_hidden=5, name="fc")
    if head == "softmax":
        return sym.SoftmaxOutput(f, name="softmax", **head_attrs)
    return sym.tanh(f, name="out")


def _values(sym, shape, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: (rng.randn(*s) * 0.3).astype("float32")
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    if "softmax_label" in args:
        args["softmax_label"] = rng.randint(0, 5, shape[0]).astype("float32")
    auxs = {n: (rng.rand(*s) + 0.5 if n.endswith("var")
                else rng.randn(*s)).astype("float32")
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _run(pkg, sym, args, auxs, reqs, steps=2, out_grads=None,
         train=True):
    """simple_bind, set the values, then ``steps`` of forward(train) +
    backward; returns (outputs, grads, aux states) as numpy."""
    ctx = pkg.cpu()
    ex = sym.simple_bind(ctx=ctx, grad_req=reqs, data=args["data"].shape)
    for k, v in args.items():
        ex.arg_dict[k][:] = pkg.nd.array(v, ctx=ctx)
    for k, v in auxs.items():
        ex.aux_dict[k][:] = pkg.nd.array(v, ctx=ctx)
    for k, g in ex.grad_dict.items():
        g[:] = 0.5                     # 'add' accumulates onto this
    for _ in range(steps):
        outs = ex.forward(is_train=train)
        if out_grads is not None:
            ex.backward([pkg.nd.array(g, ctx=ctx) for g in out_grads])
        else:
            ex.backward()
    return ([o.asnumpy() for o in outs],
            {k: v.asnumpy() for k, v in ex.grad_dict.items()},
            {k: v.asnumpy() for k, v in ex.aux_dict.items()})


# tensors whose gradient is zero in exact arithmetic -> the tensor that
# scales their tolerance
SCALE_OF = {"conv_bias": "conv_weight"}


def _close(got, want, what=""):
    scales = {}
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        scales = {i: np.abs(want[SCALE_OF[k]]).max()
                  for i, k in enumerate(sorted(want))
                  if SCALE_OF.get(k) in want}
        got, want = [got[k] for k in sorted(want)], \
            [want[k] for k in sorted(want)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        scale = scales.get(i, np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(scale, 1e-30),
                                   err_msg=f"{what} {i}")


@pytest.mark.parametrize("req", ["write", "add", "mixed"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_forward_backward_match_jax(req, fix_gamma):
    j, p = _net(jmx.sym, fix_gamma), _net(mx.sym, fix_gamma)
    args, auxs = _values(j, (3, 2, 6, 6))
    if req == "mixed":
        req = {n: r for n, r in zip(j.list_arguments(),
                                    ["null", "write", "add", "null",
                                     "write", "add", "write", "null"])}
    jo, jg, ja = _run(jmx, j, args, auxs, req)
    po, pg, pa = _run(mx, p, args, auxs, req)
    _close(po, jo, "outputs")
    _close(pg, jg, "gradients")
    _close(pa, ja, "aux states (two training forwards)")
    if fix_gamma and "bn_gamma" in pg:
        base = 0.5 if (req if isinstance(req, str)
                       else req["bn_gamma"]) == "add" else 0.0
        np.testing.assert_array_equal(pg["bn_gamma"], base)


def test_head_gradients_and_inference_match_jax():
    """A non-loss head takes the given head gradients; an inference
    forward leaves the auxiliary states alone, and the backward after it
    is a training-mode gradient (the JAX package recomputes one)."""
    j, p = _net(jmx.sym, head="tanh"), _net(mx.sym, head="tanh")
    args, auxs = _values(j, (3, 2, 6, 6), seed=1)
    hg = [np.random.RandomState(2).randn(3, 5).astype("float32")]
    for train in (True, False):
        jo, jg, ja = _run(jmx, j, args, auxs, "write", steps=1,
                          out_grads=hg, train=train)
        po, pg, pa = _run(mx, p, args, auxs, "write", steps=1,
                          out_grads=hg, train=train)
        _close(po, jo, f"outputs train={train}")
        _close(pg, jg, f"gradients train={train}")
        _close(pa, ja, f"aux states train={train}")
    for k, v in pa.items():
        np.testing.assert_array_equal(v, auxs[k])


def test_backward_without_head_gradients_needs_a_loss_head():
    p = _net(mx.sym, head="tanh")
    ex = p.simple_bind(ctx=mx.cpu(), data=(2, 2, 6, 6))
    ex.forward(is_train=True)
    with pytest.raises(ValueError, match="loss head"):
        ex.backward()
    with pytest.raises(RuntimeError, match="before forward"):
        p.simple_bind(ctx=mx.cpu(), data=(2, 2, 6, 6)).backward()


SOFTMAX_ATTRS = [
    {},
    {"grad_scale": 2.0, "normalization": "batch"},
    {"use_ignore": True, "ignore_label": 1, "normalization": "valid"},
    {"use_ignore": True, "ignore_label": 2},
    {"multi_output": True, "normalization": "valid"},
    {"preserve_shape": True},
]


@pytest.mark.parametrize("attrs", SOFTMAX_ATTRS, ids=str)
def test_softmax_output_gradient_matches_jax(attrs):
    multi = attrs.get("multi_output") or attrs.get("preserve_shape")
    shape = (4, 5, 3) if multi else (4, 5)
    lshape = (4, 3) if attrs.get("multi_output") else \
        (4, 5) if attrs.get("preserve_shape") else (4,)
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype("float32")
    k = 5 if attrs.get("multi_output") else shape[-1]
    y = rng.randint(0, k, lshape).astype("float32")

    def run(pkg):
        s = pkg.sym.SoftmaxOutput(pkg.sym.Variable("data"),
                                  pkg.sym.Variable("label"), name="sm",
                                  **attrs)
        ctx = pkg.cpu()
        ex = s.bind(ctx, args={"data": pkg.nd.array(x, ctx=ctx),
                               "label": pkg.nd.array(y, ctx=ctx)},
                    args_grad={"data": pkg.nd.zeros(shape, ctx=ctx),
                               "label": pkg.nd.zeros(lshape, ctx=ctx)})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return out, ex.grad_dict["data"].asnumpy(), \
            ex.grad_dict["label"].asnumpy()

    (jo, jg, jl), (po, pg, pl) = run(jmx), run(mx)
    _close([po, pg, pl], [jo, jg, jl], str(attrs))


def test_softmax_output_flattens_and_smooths():
    """``preserve_shape=False`` on 3-d data is a softmax over every axis
    after the first, and ``smooth_alpha`` smooths the target, as in the
    reference (the JAX op ignores both; ROADMAP.md, reference-side
    defects): against numpy."""
    rng = np.random.RandomState(6)
    x = rng.randn(3, 2, 4).astype("float32")
    y = rng.randint(0, 8, 3).astype("float32")
    alpha = 0.2
    s = mx.sym.SoftmaxOutput(mx.sym.Variable("data"),
                             mx.sym.Variable("label"), smooth_alpha=alpha)
    ex = s.bind(mx.cpu(), args={"data": mx.nd.array(x, ctx=mx.cpu()),
                                "label": mx.nd.array(y, ctx=mx.cpu())},
                args_grad={"data": mx.nd.zeros(x.shape, ctx=mx.cpu())},
                grad_req={"data": "write", "label": "null"})
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    flat = x.reshape(3, 8).astype("float64")
    p = np.exp(flat - flat.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    target = np.full((3, 8), alpha / 7)
    target[np.arange(3), y.astype(int)] = 1 - alpha
    np.testing.assert_allclose(out, p.reshape(x.shape), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                               (p - target).reshape(x.shape), rtol=0,
                               atol=1e-6)


def _bind_binary(pkg, f, lhs, rhs, out_grad):
    ctx = pkg.cpu()
    a, b = pkg.sym.Variable("lhs"), pkg.sym.Variable("rhs")
    grads = [pkg.nd.zeros(lhs.shape, ctx=ctx), pkg.nd.zeros(rhs.shape,
                                                            ctx=ctx)]
    ex = f(pkg, a, b).bind(ctx, args=[pkg.nd.array(lhs, ctx=ctx),
                                      pkg.nd.array(rhs, ctx=ctx)],
                           args_grad=grads)
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward([pkg.nd.array(out_grad, ctx=ctx)])
    return out, grads[0].asnumpy(), grads[1].asnumpy()


BINARY = {
    "add": lambda pkg, a, b: a + b,
    "sub": lambda pkg, a, b: a - b,
    "mul": lambda pkg, a, b: a * b,
    "div": lambda pkg, a, b: a / b,
    "maximum": lambda pkg, a, b: pkg.sym.maximum(a, b),
    "minimum": lambda pkg, a, b: pkg.sym.minimum(a, b),
    "dot": lambda pkg, a, b: pkg.sym.dot(a, b, transpose_b=True),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_bind_matrix_matches_jax(op):
    rng = np.random.RandomState(len(op))
    lhs = rng.uniform(-1, 1, (3, 4)).astype("float32") + 2.0
    rhs = rng.uniform(-1, 1, (3, 4)).astype("float32") + 2.0
    oshape = (3, 3) if op == "dot" else (3, 4)
    og = rng.randn(*oshape).astype("float32")
    _close(list(_bind_binary(mx, BINARY[op], lhs, rhs, og)),
           list(_bind_binary(jmx, BINARY[op], lhs, rhs, og)), op)


def test_copy_params_monitor_and_outputs_own_memory():
    s = _net(mx.sym, head="tanh")
    args, auxs = _values(s, (2, 2, 6, 6))
    ex = s.simple_bind(ctx=mx.cpu(), grad_req="null", data=(2, 2, 6, 6))
    ex.copy_params_from({k: mx.nd.array(v, ctx=mx.cpu())
                         for k, v in args.items()},
                        {k: mx.nd.array(v, ctx=mx.cpu())
                         for k, v in auxs.items()})
    for k, v in args.items():
        np.testing.assert_array_equal(ex.arg_dict[k].asnumpy(), v)
    with pytest.raises(ValueError, match="unknown argument"):
        ex.copy_params_from({"nope": mx.nd.zeros((1,), ctx=mx.cpu())})
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append(name))
    ex.forward()
    assert seen == ["out_output"]
    seen.clear()
    ex.set_monitor_callback(lambda name, arr: seen.append(name),
                            monitor_all=True)
    ex.forward()
    assert seen == ["conv", "bn", "relu", "fc", "out"]
    # an output that is a bound array itself is a copy of it
    ident = mx.sym.Variable("x")
    ex2 = ident.bind(mx.cpu(), args={"x": mx.nd.ones((2,), ctx=mx.cpu())})
    out = ex2.forward()[0]
    ex2.arg_dict["x"][:] = 5.0
    np.testing.assert_array_equal(out.asnumpy(), [1.0, 1.0])


def test_one_context_per_executor():
    s = _net(mx.sym)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        s.simple_bind(ctx=[mx.cpu(0), mx.cpu(1)], data=(2, 2, 6, 6))
    ex = s.simple_bind(ctx=[mx.cpu()], data=(2, 2, 6, 6))
    assert ex.arg_dict["data"].context == mx.cpu()


def test_simple_bind_places_on_the_current_context(monkeypatch):
    """``ctx=None`` is the current context: under ``with mx.cpu():`` the
    CPU, else the GPU, which raises without one."""
    s = _net(mx.sym)
    with mx.cpu():
        ex = s.simple_bind(data=(2, 2, 6, 6))
    assert all(a.context == mx.cpu() for a in ex.arg_arrays)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.simple_bind(data=(2, 2, 6, 6))
