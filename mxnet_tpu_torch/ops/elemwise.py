"""Elementwise unary, binary and scalar ops (counterpart of
``mxnet_tpu/ops/elemwise.py``): one torch function each.

MXNet's conventions kept here, where torch's own would differ:
- ``round`` rounds ties away from zero (``torch.round`` rounds them to
  even; ``rint`` does, in both);
- ``_mod`` is the divisor-signed ``torch.remainder``, not ``fmod``;
- comparisons and logic ops return 0/1 in the input's dtype;
- a scalar operand takes the array's dtype first (``x + 2.5`` on an int32
  array adds 2), and ``_maximum``/``_minimum`` send the whole gradient to
  the left operand at ties (MXNet's ``ge``/``le`` backward);
- ``cast`` keeps int64 (the JAX package maps it to int32: it runs without
  x64).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import parse_float, torch_dtype
from .nn import activation
from .registry import register


def _unary(name, tfn, aliases=()):
    def fn(x):
        return tfn(x)
    fn.__name__ = name
    fn.__doc__ = f"Elementwise {name}."
    register(name, aliases=aliases)(fn)
    return fn


def _float(x):
    """Integer and bool inputs of a float function compute in float32."""
    return x if x.is_floating_point() else x.float()


def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _gamma(x):
    """Γ itself (not exp(lnΓ) = |Γ|): negative between the poles -1-2k and
    -2k."""
    x = _float(x)
    neg = (x < 0) & (torch.remainder(torch.floor(x), 2) != 0)
    return torch.exp(torch.lgamma(x)) * torch.where(neg, -1.0, 1.0).to(x)


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", lambda x: torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
       if x.is_floating_point() else x.clone())
_unary("rint", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", lambda x: torch.sqrt(_float(x)))
_unary("rsqrt", lambda x: torch.rsqrt(_float(x)))
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", lambda x: torch.exp(_float(x)))
_unary("log", lambda x: torch.log(_float(x)))
_unary("log10", lambda x: torch.log10(_float(x)))
_unary("log2", lambda x: torch.log2(_float(x)))
_unary("log1p", lambda x: torch.log1p(_float(x)))
_unary("expm1", lambda x: torch.expm1(_float(x)))
_unary("sin", lambda x: torch.sin(_float(x)))
_unary("cos", lambda x: torch.cos(_float(x)))
_unary("tan", lambda x: torch.tan(_float(x)))
_unary("arcsin", lambda x: torch.asin(_float(x)))
_unary("arccos", lambda x: torch.acos(_float(x)))
_unary("arctan", lambda x: torch.atan(_float(x)))
_unary("sinh", lambda x: torch.sinh(_float(x)))
_unary("cosh", lambda x: torch.cosh(_float(x)))
_unary("tanh", lambda x: torch.tanh(_float(x)))
_unary("arcsinh", lambda x: torch.asinh(_float(x)))
_unary("arccosh", lambda x: torch.acosh(_float(x)))
_unary("arctanh", lambda x: torch.atanh(_float(x)))
_unary("degrees", lambda x: torch.rad2deg(_float(x)))
_unary("radians", lambda x: torch.deg2rad(_float(x)))
_unary("negative", torch.neg, aliases=("_np_negative",))
_unary("reciprocal", lambda x: 1.0 / x)
_unary("sigmoid", lambda x: torch.sigmoid(_float(x)))
_unary("softsign", lambda x: F.softsign(_float(x)))
_unary("relu", torch.relu)
_unary("erf", lambda x: torch.erf(_float(x)))
_unary("erfinv", lambda x: torch.erfinv(_float(x)))
_unary("gammaln", lambda x: torch.lgamma(_float(x)))
_unary("gamma", _gamma)
_unary("logical_not", lambda x: (x == 0).to(x.dtype))
_unary("isnan", torch.isnan)
_unary("isinf", torch.isinf)
_unary("isfinite", torch.isfinite)
_unary("size_array", lambda x: torch.tensor([x.numel()], dtype=torch.int64,
                                            device=x.device))
_unary("shape_array", lambda x: torch.tensor(x.shape, dtype=torch.int64,
                                             device=x.device))


@register("_copy", aliases=("identity",))
def _copy(x):
    """Identity copy."""
    return x.clone()


@register("_copyto")
def _copyto(x):
    """``_copyto``: a copy; placement is the frontend's (``copyto``)."""
    return x.clone()


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(x):
    """Stops the gradient."""
    return x.detach()


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.ones_like(g)


@register("make_loss")
def make_loss(x):
    """Forward identity; the input's gradient is all ones whatever the
    incoming one (``MakeLoss``)."""
    return _MakeLoss.apply(x)


@register("clip")
def clip(x, a_min=None, a_max=None):
    """Clip into [a_min, a_max]; zero gradient outside."""
    return torch.clamp(x, parse_float(a_min), parse_float(a_max))


@register("LeakyReLU")
def leaky_relu(x, *args, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    """``leaky``/``elu``/``selu``/``gelu``/``prelu`` (gamma as the second
    input)/``rrelu`` (the mean slope)."""
    slope = parse_float(slope, 0.25)
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "prelu":
        gamma = args[0]
        if gamma.dim() == 1:
            gamma = gamma.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x > 0, x, gamma * x)
    if act_type == "rrelu":
        slope = (parse_float(lower_bound, 0.125) +
                 parse_float(upper_bound, 0.334)) / 2
        return torch.where(x > 0, x, slope * x)
    raise ValueError(f"unknown LeakyReLU act_type {act_type}")


register("Activation")(activation)


@register("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(parse_float(alpha, 0.2) * x + parse_float(beta, 0.5),
                       0, 1)


@register("softplus")
def softplus(x):
    return F.softplus(x)


def _binary(name, tfn, aliases=()):
    def fn(lhs, rhs):
        return tfn(lhs, rhs)
    fn.__name__ = name
    register(name, aliases=aliases)(fn)
    return fn


def _cmp(tfn):
    return lambda a, b: tfn(a, b).to(a.dtype)


def _nz(x):
    return x != 0


_binary("elemwise_add", torch.add, aliases=("_plus", "_add"))
_binary("elemwise_sub", torch.sub, aliases=("_minus", "_sub"))
_binary("elemwise_mul", torch.mul, aliases=("_mul",))
_binary("elemwise_div", torch.true_divide, aliases=("_div",))
_binary("_maximum", lambda a, b: torch.where(a >= b, a, b))
_binary("_minimum", lambda a, b: torch.where(a <= b, a, b))
_binary("_hypot", lambda a, b: torch.hypot(_float(a), _float(b)))
_binary("_power", torch.pow, aliases=("_Power",))
_binary("_mod", torch.remainder)
_binary("_equal", _cmp(torch.eq))
_binary("_not_equal", _cmp(torch.ne))
_binary("_greater", _cmp(torch.gt))
_binary("_greater_equal", _cmp(torch.ge))
_binary("_lesser", _cmp(torch.lt))
_binary("_lesser_equal", _cmp(torch.le))
_binary("_logical_and", lambda a, b: (_nz(a) & _nz(b)).to(a.dtype))
_binary("_logical_or", lambda a, b: (_nz(a) | _nz(b)).to(a.dtype))
_binary("_logical_xor", lambda a, b: (_nz(a) ^ _nz(b)).to(a.dtype))
_binary("_grad_add", torch.add)
# divides only the stored values of a sparse lhs: plain division on dense
# arrays
_binary("_scatter_elemwise_div", torch.true_divide)


@register("add_n", wrap_list=True, aliases=("ElementWiseSum", "_sum"))
def add_n(*args):
    """Sum of N arrays."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def _as_kind(s, x):
    """Scalar ``s`` in ``x``'s kind: MXNet casts the scalar to the array's
    dtype (an int32 array adds ``int(2.5)``)."""
    if x.dtype is torch.bool:
        return bool(s)
    return s if x.is_floating_point() else int(s)


def _scalar(name, tfn):
    def fn(x, scalar=1.0):
        return tfn(x, _as_kind(parse_float(scalar, 1.0), x))
    fn.__name__ = name
    register(name)(fn)
    return fn


def _rpow(x, s):
    return torch.pow(torch.tensor(s, dtype=x.dtype, device=x.device), x)


_scalar("_plus_scalar", torch.add)
_scalar("_minus_scalar", torch.sub)
_scalar("_rminus_scalar", lambda x, s: s - x)
_scalar("_mul_scalar", torch.mul)
_scalar("_div_scalar", torch.true_divide)
_scalar("_rdiv_scalar", lambda x, s: s / x)
_scalar("_mod_scalar", torch.remainder)
_scalar("_rmod_scalar", lambda x, s: torch.remainder(
    torch.tensor(s, dtype=x.dtype, device=x.device), x))
_scalar("_power_scalar", torch.pow)
_scalar("_rpower_scalar", _rpow)
_scalar("_maximum_scalar", lambda x, s: torch.where(x >= s, x, s))
_scalar("_minimum_scalar", lambda x, s: torch.where(x <= s, x, s))
_scalar("_hypot_scalar", lambda x, s: torch.hypot(
    _float(x), torch.tensor(float(s), device=x.device)))
_scalar("_equal_scalar", lambda x, s: (x == s).to(x.dtype))
_scalar("_not_equal_scalar", lambda x, s: (x != s).to(x.dtype))
_scalar("_greater_scalar", lambda x, s: (x > s).to(x.dtype))
_scalar("_greater_equal_scalar", lambda x, s: (x >= s).to(x.dtype))
_scalar("_lesser_scalar", lambda x, s: (x < s).to(x.dtype))
_scalar("_lesser_equal_scalar", lambda x, s: (x <= s).to(x.dtype))
_scalar("_logical_and_scalar", lambda x, s: (_nz(x) & (s != 0)).to(x.dtype))
_scalar("_logical_or_scalar", lambda x, s: (_nz(x) | (s != 0)).to(x.dtype))
_scalar("_logical_xor_scalar", lambda x, s: (_nz(x) ^ (s != 0)).to(x.dtype))
# touch only the stored values of a sparse input: the plain ops on dense
# arrays
_scalar("_scatter_plus_scalar", torch.add)
_scalar("_scatter_minus_scalar", torch.sub)
_scalar("smooth_l1", lambda x, s: torch.where(
    torch.abs(x) < 1.0 / (s * s), 0.5 * s * s * x * x,
    torch.abs(x) - 0.5 / (s * s)))


@register("cast", aliases=("Cast",))
def cast(x, dtype="float32"):
    """``Cast``: to ``dtype`` (int64 stays int64)."""
    return x.to(torch_dtype(dtype))


@register("where")
def where(condition, x, y):
    """Elementwise select; a 1-D ``condition`` with x, y of more axes
    selects whole rows along the first axis."""
    cond = condition.to(torch.bool)
    if cond.dim() == 1 and x.dim() > 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond, x, y)


@register("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register("amp_cast")
def amp_cast(data, dtype=None):
    """The cast AMP inserts around listed ops: identity up to dtype."""
    return data.to(torch_dtype(dtype))


@register("amp_multicast")
def amp_multicast(*data, num_outputs=None):
    """Cast every input to the widest of their dtypes."""
    dt = data[0].dtype
    for d in data[1:]:
        dt = torch.promote_types(dt, d.dtype)
    return tuple(d.to(dt) for d in data)


def _bitwise(name, tfn):
    def fn(a, b):
        return tfn(a.to(torch.int32), b.to(torch.int32))
    fn.__name__ = name
    register(f"_contrib_{name}", aliases=(name,))(fn)


_bitwise("bitwise_and", torch.bitwise_and)
_bitwise("bitwise_or", torch.bitwise_or)
_bitwise("bitwise_xor", torch.bitwise_xor)


@register("digamma")
def digamma(a):
    return torch.digamma(_float(a))

