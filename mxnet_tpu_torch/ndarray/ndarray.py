"""NDArray: MXNet's tensor handle, on a ``torch.Tensor`` (counterpart of
``mxnet_tpu/ndarray/ndarray.py``).

An ``NDArray`` is a mutable handle: ``_data`` is the tensor it holds, and
every op returns a new handle (``invoke`` runs the op table's torch
function).  Autograd is torch's: ``attach_grad`` marks the tensor (a leaf
that takes a gradient), ``record()`` is torch's grad mode, ``x.grad`` reads
the tensor's ``.grad`` each time it is asked (``backward`` writes that
buffer in place) and ``backward`` is ``autograd.backward``.

What departs from a plain translation, and why:

- Values, not views.  As in the JAX package (``ndarray.py:14-17``), an op's
  output never shares memory with its inputs: basic indexing, ``reshape``,
  ``transpose`` and every other op whose torch result is a view of an input
  return a copy (``_own``), so a later in-place write to the input does not
  change them.
- In-place writes (``+=``, ``x[k] = v``, ``copyto``, ``out=``).  Outside
  ``autograd.record()`` they write into the tensor under ``torch.no_grad()``:
  a Parameter, a Trainer or another handle that holds the tensor sees the
  write, and ``w -= lr * w.grad`` works on a marked variable.  Inside
  ``record()`` (and for a tensor that is itself a recorded result, or a
  write that changes the shape) the handle is rebound to the out-of-place
  result, as the JAX package rebinds (``:316-328``): torch refuses an
  in-place op on a leaf that requires grad, and would refuse the backward
  of a graph whose saved tensor was written.
- No engine: there is no lazy bulking, eager-jit cache, sanitizer fence
  or operand capture (ROADMAP.md).  ``wait_to_read`` and ``asnumpy``
  synchronise the tensor's stream only; ``waitall`` every device.
- AMP: its cast policy (``ops.registry.amp_policy``, set by
  ``contrib.amp.init``) rewrites an op's inputs in ``invoke``, as the JAX
  package's ``_AMP_HOOK`` does.
- Integer widths: int64 stays int64 (MXNet 1.5 keeps it; the JAX package
  runs without x64 and makes it int32).
- ``dtype`` is a numpy dtype, except bfloat16, which numpy lacks: it is
  ``base.bfloat16`` (``torch.bfloat16``), and ``asnumpy`` of a bfloat16
  array gives its values exactly as float32.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..base import dtype_of, np_dtype, torch_dtype
from ..context import Context, as_device
from ..ops import registry as _reg
from . import serialization

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full",
           "zeros_like", "ones_like", "arange", "eye", "concatenate",
           "stack", "moveaxis", "transpose", "waitall", "invoke",
           "invoke_op", "invoke_fn", "save", "load", "load_frombuffer"]


class NDArray:
    """A handle on a torch tensor with MXNet's NDArray interface."""

    __slots__ = ("_data", "__weakref__")

    def __init__(self, data):
        self._data = data

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return dtype_of(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context.from_device(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return transpose(self)

    @property
    def grad(self):
        """The gradient buffer of a marked array (``attach_grad``), read
        from the tensor each time; ``None`` before one is attached."""
        g = self._data.grad
        return None if g is None else NDArray(g)

    @property
    def data(self):
        """The torch tensor this handle holds (an escape hatch, as the JAX
        package's ``data`` is its ``jax.Array``)."""
        return self._data

    # ------------------------------------------------------------ sync/query
    def _sync(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def wait_to_read(self):
        """Wait until the tensor's value is computed: its device's current
        stream, not every stream (``NDArray::WaitToRead``)."""
        self._sync()
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy of the value (never a view of a CPU tensor, which a
        later in-place write would change)."""
        t = self._data.detach()
        if t.dtype is torch.bfloat16:
            t = t.float()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous")
        return bool(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return (f"\n{self.asnumpy()!r}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # ----------------------------------------------------------------- dtype
    def astype(self, dtype, copy=True):
        if not copy and torch_dtype(dtype) == self._data.dtype:
            return self
        return invoke_op("cast", [self], {"dtype": dtype})

    def copy(self):
        return invoke_op("_copy", [self], {})

    def copyto(self, other):
        """Copy into ``other``: an NDArray (written in place, cast to its
        dtype, across devices) or a Context (a new array there)."""
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True))
        if isinstance(other, NDArray):
            _write(other, self._data.to(device=other._data.device,
                                        dtype=other._data.dtype))
            return other
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, ctx):
        device = as_device(ctx)
        if Context.from_device(device) == self.context:
            return self
        return NDArray(self._data.to(device))

    as_in_ctx = as_in_context

    def tostype(self, stype):
        if stype == "default":
            return self
        raise NotImplementedError(
            f"storage type {stype!r}: the port stores dense arrays only; "
            f"sparse storage is queued in ROADMAP.md (queue 1, item 11)")

    # --------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Mark this array as a variable with a zeroed gradient buffer.  A
        recorded result is detached first: it becomes a new variable, as in
        MXNet."""
        if stype not in (None, "default"):
            self.tostype(stype)
        if self._data.grad_fn is not None:
            self._data = self._data.detach()
        autograd.mark_variables([self._data],
                                [torch.zeros_like(self._data)],
                                grad_reqs=grad_req)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # --------------------------------------------------------------- indexing
    def __getitem__(self, key):
        key, flips = _index_key(key, self._data)
        data = self._data.flip(flips) if flips else self._data
        return NDArray(_own(data[key], (self._data,)))

    def __setitem__(self, key, value):
        key, flips = _index_key(key, self._data)
        if isinstance(value, NDArray):
            value = value._data.to(self._data.device)
        elif isinstance(value, (np.ndarray, list)):
            value = torch.as_tensor(np.asarray(value),
                                    device=self._data.device)
        if flips:
            # write the flipped copy, then flip it back
            res = self._data.flip(flips)
            res[key] = value
            res = res.flip(flips)
            if _rebinds(self):
                self._data = res
            else:
                with torch.no_grad():
                    self._data.copy_(res)
        elif _rebinds(self):
            res = self._data.clone()
            res[key] = value
            self._data = res
        else:
            with torch.no_grad():
                self._data[key] = value

    def slice(self, begin, end, step=None):
        return invoke_op("slice", [self], {"begin": begin, "end": end,
                                           "step": step})

    def slice_axis(self, axis, begin, end):
        return invoke_op("slice_axis", [self], {"axis": axis, "begin": begin,
                                                "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return invoke_op("take", [self, indices], {"axis": axis,
                                                   "mode": mode})

    # ------------------------------------------------------------- arithmetic
    def _inplace(self, res):
        _write(self, res._data)
        return self

    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(self, other)

    def __iadd__(self, other):
        return self._inplace(add(self, other))

    def __sub__(self, other):
        return subtract(self, other)

    def __rsub__(self, other):
        return subtract(other, self)

    def __isub__(self, other):
        return self._inplace(subtract(self, other))

    def __mul__(self, other):
        return multiply(self, other)

    def __rmul__(self, other):
        return multiply(self, other)

    def __imul__(self, other):
        return self._inplace(multiply(self, other))

    def __truediv__(self, other):
        return divide(self, other)

    def __rtruediv__(self, other):
        return divide(other, self)

    def __itruediv__(self, other):
        return self._inplace(divide(self, other))

    def __mod__(self, other):
        return modulo(self, other)

    def __rmod__(self, other):
        return modulo(other, self)

    def __pow__(self, other):
        return power(self, other)

    def __rpow__(self, other):
        return power(other, self)

    def __neg__(self):
        return invoke_op("negative", [self], {})

    def __abs__(self):
        return invoke_op("abs", [self], {})

    def __eq__(self, other):
        return equal(self, other)

    def __ne__(self, other):
        return not_equal(self, other)

    def __lt__(self, other):
        return lesser(self, other)

    def __le__(self, other):
        return lesser_equal(self, other)

    def __gt__(self, other):
        return greater(self, other)

    def __ge__(self, other):
        return greater_equal(self, other)

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------- method shortcuts
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        elif not shape:
            shape = kwargs.get("shape")
        return invoke_op("reshape", [self], {"shape": shape})

    def reshape_like(self, other):
        return invoke_op("reshape_like", [self, other], {})

    def broadcast_to(self, shape):
        return invoke_op("broadcast_to", [self], {"shape": shape})

    def broadcast_like(self, other):
        return invoke_op("broadcast_like", [self, other], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return invoke_op("transpose", [self], {"axes": axes or None})

    def swapaxes(self, dim1, dim2):
        return invoke_op("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def flatten(self):
        return invoke_op("flatten", [self], {})

    def expand_dims(self, axis):
        return invoke_op("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return invoke_op("squeeze", [self], {"axis": axis})

    def _reduce(self, name, axis, keepdims):
        return invoke_op(name, [self], {"axis": axis, "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def nansum(self, axis=None, keepdims=False):
        return self._reduce("nansum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke_op("norm", [self], {"ord": ord, "axis": axis,
                                          "keepdims": keepdims})

    def abs(self):
        return invoke_op("abs", [self], {})

    def sign(self):
        return invoke_op("sign", [self], {})

    def sqrt(self):
        return invoke_op("sqrt", [self], {})

    def square(self):
        return invoke_op("square", [self], {})

    def exp(self):
        return invoke_op("exp", [self], {})

    def log(self):
        return invoke_op("log", [self], {})

    def clip(self, a_min, a_max):
        return invoke_op("clip", [self], {"a_min": a_min, "a_max": a_max})

    def round(self):
        return invoke_op("round", [self], {})

    def softmax(self, axis=-1):
        return invoke_op("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke_op("log_softmax", [self], {"axis": axis})

    def relu(self):
        return invoke_op("relu", [self], {})

    def sigmoid(self):
        return invoke_op("sigmoid", [self], {})

    def tanh(self):
        return invoke_op("tanh", [self], {})

    def tile(self, reps):
        return invoke_op("tile", [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke_op("repeat", [self], {"repeats": repeats, "axis": axis})

    def pad(self, mode="constant", pad_width=None, constant_value=0):
        return invoke_op("pad", [self], {"mode": mode, "pad_width": pad_width,
                                         "constant_value": constant_value})

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return invoke_op("one_hot", [self], {
            "depth": depth, "on_value": on_value, "off_value": off_value,
            "dtype": dtype})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke_op("topk", [self], {"axis": axis, "k": k,
                                          "ret_typ": ret_typ,
                                          "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return invoke_op("sort", [self], {"axis": axis,
                                          "is_ascend": is_ascend})

    def argsort(self, axis=-1, is_ascend=True):
        return invoke_op("argsort", [self], {"axis": axis,
                                             "is_ascend": is_ascend})

    def dot(self, other, **kwargs):
        return invoke_op("dot", [self, other], kwargs)


# ------------------------------------------------------------------ writes
def _rebinds(arr):
    """True where a write to ``arr`` must rebind the handle instead of
    writing the tensor (see the module docstring)."""
    return autograd.is_recording() or arr._data.grad_fn is not None


def _write(dst, value):
    """Give ``dst`` the value of tensor ``value``: in place, cast to its
    dtype, where the shapes match and :func:`_rebinds` allows; else by
    rebinding."""
    if _rebinds(dst) or value.shape != dst._data.shape:
        dst._data = value
    else:
        with torch.no_grad():
            dst._data.copy_(value)


def _own(t, inputs):
    """``t``, or a copy of it where it shares memory with one of
    ``inputs`` (a view, or the input itself)."""
    if t.numel() == 0:
        return t
    ptr = t.untyped_storage().data_ptr()
    if any(x.numel() and x.untyped_storage().data_ptr() == ptr
           for x in inputs):
        return t.clone()
    return t


# ---------------------------------------------------------------- indexing
def _index_tensor(k, device):
    """An NDArray, numpy array or list used as an index: integers (MXNet's
    float index arrays become int64) or a boolean mask, on ``device``."""
    t = k._data if isinstance(k, NDArray) else torch.as_tensor(np.asarray(k))
    if t.dtype is not torch.bool:
        t = t.long()
    return t.to(device)


def _index_key(key, data):
    """``(key as torch indexes data, axes to flip first)``: index arrays as
    tensors on its device, clamped into their axis as the JAX package's
    gather clamps (an out-of-range gather on the card would be a device
    fault), negative entries counting from the end.  Torch takes no
    negative slice step, so a slice with one becomes the positive-step
    slice of the same elements of ``data`` flipped along that axis
    (``x[::-1]`` is ``x.flip(0)[0:n:1]``), which keeps the gradient."""
    keys = key if isinstance(key, tuple) else (key,)
    out, flips, dim = [], [], 0
    for pos, k in enumerate(keys):
        if k is None or isinstance(k, (bool, np.bool_)):
            out.append(k)          # a new axis (numpy's rule for a bool)
            continue
        if k is Ellipsis:
            rest = sum(1 for kk in keys[pos + 1:]
                       if kk is not None and kk is not Ellipsis)
            dim = data.dim() - rest
            out.append(k)
            continue
        if isinstance(k, (NDArray, np.ndarray, list)):
            k = _index_tensor(k, data.device)
            if k.dtype is torch.bool:
                dim += k.dim()
            else:
                n = data.shape[dim]
                k = torch.where(k < 0, k + n, k).clamp(0, n - 1)
                dim += 1
        else:
            if isinstance(k, (int, np.integer)) and dim < data.dim() and \
                    not -data.shape[dim] <= k < data.shape[dim]:
                raise IndexError(f"index {k} is out of bounds for axis "
                                 f"{dim} with size {data.shape[dim]}")
            if isinstance(k, slice) and k.step is not None and \
                    k.step < 0 and dim < data.dim():
                n = data.shape[dim]
                start, stop, step = k.indices(n)
                # element i of the axis is element n - 1 - i of the flip
                k = slice(n - 1 - start, n - 1 - stop, -step)
                flips.append(dim)
            dim += 1
        out.append(k)
    return (tuple(out) if isinstance(key, tuple) else out[0]), flips


# ------------------------------------------------------------ invoke path
def _as_nd(x, dtype=None, ctx=None):
    """``x`` as an NDArray: a torch tensor is wrapped as it is; anything
    else is made with :func:`array`'s rules on ``ctx``."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, torch.Tensor) and dtype is None:
        return NDArray(x)
    return array(x, ctx=ctx, dtype=dtype)


def invoke_op(name, nd_inputs, attrs, out=None):
    return invoke(_reg.require(name), nd_inputs, attrs, out=out)


def invoke(op, nd_inputs, attrs, out=None):
    """Run ``op`` on the tensors of ``nd_inputs`` (anything else is made an
    array on the first NDArray's device) and wrap its outputs; ``out``
    (an NDArray or a list) receives them instead (see ``_write``)."""
    device = next((x._data.device for x in nd_inputs
                   if isinstance(x, NDArray)), None)
    raw = [_as_nd(x, ctx=device)._data for x in nd_inputs]
    if any(isinstance(v, NDArray) for v in attrs.values()):
        # optional array inputs passed by keyword (``sequence_length=``)
        attrs = {k: (v._data if isinstance(v, NDArray) else v)
                 for k, v in attrs.items()}
    if _reg.amp_policy is not None:
        raw = _reg.amp_policy((op.name,) + op.aliases, raw)
    result = op.fn(*raw, **attrs)
    single = not isinstance(result, (tuple, list))
    outs = [_own(r, raw) for r in ([result] if single else result)]
    if out is not None:
        dsts = [out] if isinstance(out, NDArray) else list(out)
        for dst, r in zip(dsts, outs):
            _write(dst, r)
        return out
    return NDArray(outs[0]) if single else [NDArray(r) for r in outs]


def invoke_fn(fn, nd_inputs, attrs=None):
    """Run an ad-hoc torch function through the same path as an op."""
    raw = [_as_nd(x)._data for x in nd_inputs]
    result = fn(*raw, **(attrs or {}))
    if isinstance(result, (tuple, list)):
        return [NDArray(_own(r, raw)) for r in result]
    return NDArray(_own(result, raw))


# ---------------------------------------------------------------- creation
def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (the current context by default) holding a
    copy of ``source_array``.  MXNet's dtype rules: lists and scalars give
    float32, a numpy array or tensor keeps its dtype but float64 becomes
    float32; ``dtype`` overrides."""
    device = as_device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
    else:
        src = np.asarray(source_array) if isinstance(
            source_array, np.ndarray) else np.asarray(source_array,
                                                      dtype=np.float32)
        if not src.flags.writeable:
            src = src.copy()
        t = torch.as_tensor(src)
    if dtype is not None:
        dt = torch_dtype(dtype)
    else:
        dt = torch.float32 if t.dtype is torch.float64 else t.dtype
    return NDArray(t.to(device=device, dtype=dt, copy=True))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=as_device(ctx)))


empty = zeros


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=as_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=as_device(ctx)))


def zeros_like(other, **kwargs):
    return NDArray(torch.zeros_like(other._data))


def ones_like(other, **kwargs):
    return NDArray(torch.ones_like(other._data))


def arange(start, stop=None, step=1.0, repeat=1, infer_range=False,
           ctx=None, dtype=None):
    from ..ops.init_ops import _arange
    return NDArray(_arange(start, stop, step, repeat, ctx=as_device(ctx),
                           dtype=np_dtype(dtype)))


def eye(N, M=0, k=0, ctx=None, dtype=None):
    from ..ops.init_ops import _eye
    return NDArray(_eye(N, M, k, ctx=as_device(ctx), dtype=np_dtype(dtype)))


def concatenate(arrays, axis=0, always_copy=True):
    return invoke_op("concat", arrays, {"dim": axis})


def stack(*arrays, axis=0):
    return invoke_op("stack", list(arrays), {"axis": axis})


def moveaxis(tensor, source, destination):
    return invoke_fn(lambda x: torch.movedim(x, source, destination),
                     [tensor])


def transpose(data, axes=None):
    return invoke_op("transpose", [data], {"axes": axes})


def waitall():
    """Wait for all work on every device (``Engine::WaitForAll``)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _binary(name, scalar_name, rscalar_name=None):
    """Array-array ops broadcast; with a scalar they take the scalar op
    (``_plus_scalar``...), reflected where the order matters."""
    def f(lhs, rhs):
        if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
            return invoke_op(name, [lhs, rhs], {})
        if isinstance(lhs, NDArray):
            return invoke_op(scalar_name, [lhs], {"scalar": float(rhs)})
        if isinstance(rhs, NDArray):
            return invoke_op(rscalar_name or scalar_name, [rhs],
                             {"scalar": float(lhs)})
        raise TypeError("at least one argument must be an NDArray")
    f.__name__ = name
    return f


add = _binary("broadcast_add", "_plus_scalar")
subtract = _binary("broadcast_sub", "_minus_scalar", "_rminus_scalar")
multiply = _binary("broadcast_mul", "_mul_scalar")
divide = _binary("broadcast_div", "_div_scalar", "_rdiv_scalar")
modulo = _binary("broadcast_mod", "_mod_scalar", "_rmod_scalar")
power = _binary("broadcast_power", "_power_scalar", "_rpower_scalar")
maximum = _binary("broadcast_maximum", "_maximum_scalar")
minimum = _binary("broadcast_minimum", "_minimum_scalar")
equal = _binary("broadcast_equal", "_equal_scalar")
not_equal = _binary("broadcast_not_equal", "_not_equal_scalar")
greater = _binary("broadcast_greater", "_greater_scalar", "_lesser_scalar")
greater_equal = _binary("broadcast_greater_equal", "_greater_equal_scalar",
                        "_lesser_equal_scalar")
lesser = _binary("broadcast_lesser", "_lesser_scalar", "_greater_scalar")
lesser_equal = _binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                       "_greater_equal_scalar")
logical_and = _binary("broadcast_logical_and", "_logical_and_scalar")
logical_or = _binary("broadcast_logical_or", "_logical_or_scalar")
logical_xor = _binary("broadcast_logical_xor", "_logical_xor_scalar")


# -------------------------------------------------------------- .params files
def save(fname, data):
    """Write NDArrays (one, a list or a ``{name: array}`` dict; tensors and
    numpy arrays are taken too) in MXNet's ``.params`` format."""
    def raw(a):
        return a._data if isinstance(a, NDArray) else a
    if isinstance(data, dict):
        data = {k: raw(v) for k, v in data.items()}
    elif isinstance(data, (list, tuple)):
        data = [raw(a) for a in data]
    else:
        data = raw(data)
    serialization.save(fname, data)


def _wrap_loaded(loaded):
    if isinstance(loaded, dict):
        return {k: NDArray(v) for k, v in loaded.items()}
    return [NDArray(v) for v in loaded]


def load(fname):
    """``{name: NDArray}`` (or a list), on ``cpu(0)``, where the file's
    context field puts them."""
    return _wrap_loaded(serialization.load(fname))


def load_frombuffer(buf):
    return _wrap_loaded(serialization.load_frombuffer(buf))
