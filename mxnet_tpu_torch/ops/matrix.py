"""Shape, indexing, ordering and product ops (counterpart of
``mxnet_tpu/ops/matrix.py``).

Every tensor an op makes (index ranges, one-hot tables, histogram edges)
is made on its input's device.  Index arrays may be float (MXNet's
default); they are read as integers.  Out-of-range indices are clipped (or
wrapped, ``take(mode="wrap")``) as the JAX package's gathers clamp them.
``argsort`` and ``topk`` sort stably, so ties keep their order as
``jnp.argsort`` and ``lax.top_k`` keep it, and return indices as float32
unless ``dtype`` says otherwise.
"""
from __future__ import annotations

import ast

import torch
import torch.nn.functional as F

from ..base import (parse_bool, parse_float, parse_int, parse_tuple,
                    torch_dtype)
from .nn import embedding as _embedding
from .registry import register


# ------------------------------------------------------------ reshape family
@register("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False, target_shape=None,
            keep_highest=False):
    """``Reshape`` with MXNet's codes: 0 copies a dim, -1 infers one, -2
    copies the rest, -3 merges two, -4 splits one into the next two."""
    if target_shape is not None and shape is None:
        # the legacy target_shape: 0 means "infer", not "copy"
        shape = tuple(-1 if int(v) == 0 else int(v)
                      for v in parse_tuple(target_shape))
    shape = parse_tuple(shape)
    src = list(data.shape)
    rev = parse_bool(reverse)
    if rev:
        src = src[::-1]
        shape = tuple(reversed(shape))
    out, si, i = [], 0, 0
    while i < len(shape):
        s = shape[i]
        if s == 0:
            out.append(src[si])
            si += 1
        elif s == -1:
            out.append(-1)
            si += 1
        elif s == -2:
            out.extend(src[si:])
            si = len(src)
        elif s == -3:
            out.append(src[si] * src[si + 1])
            si += 2
        elif s == -4:
            d1, d2 = shape[i + 1], shape[i + 2]
            if d1 == -1:
                d1 = src[si] // d2
            if d2 == -1:
                d2 = src[si] // d1
            out.extend([d1, d2])
            si += 1
            i += 2
        else:
            out.append(s)
            if si < len(src):
                si += 1
        i += 1
    if rev:
        out = out[::-1]
    return data.reshape(tuple(out))


@register("reshape_like")
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    if all(v is None for v in (lhs_begin, lhs_end, rhs_begin, rhs_end)):
        return lhs.reshape(rhs.shape)
    lb = parse_int(lhs_begin, 0) or 0
    le = parse_int(lhs_end, lhs.dim())
    rb = parse_int(rhs_begin, 0) or 0
    re_ = parse_int(rhs_end, rhs.dim())
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_]) +
                       tuple(lhs.shape[le:]))


@register("Flatten", aliases=("flatten",))
def flatten(data):
    """Collapse all but the first axis."""
    return data.reshape(data.shape[0], -1)


@register("transpose")
def transpose(data, axes=None):
    axes = parse_tuple(axes) if axes else tuple(reversed(range(data.dim())))
    return data.permute(axes)


@register("expand_dims")
def expand_dims(data, axis=0):
    return data.unsqueeze(parse_int(axis, 0))


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(parse_tuple(axis))


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return data.transpose(parse_int(dim1, 0), parse_int(dim2, 0))


@register("depth_to_space")
def depth_to_space(data, block_size=1):
    b = parse_int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size=1):
    b = parse_int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ------------------------------------------------- slicing, concat, split
def _spec(v, ndim):
    if v is None:
        return [None] * ndim
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, int):
        v = (v,)
    return list(v) + [None] * (ndim - len(v))


def _slices(data, begin, end, step):
    """``(positive slices, axes to flip)``: a slice of negative step is the
    flip of the positive slice over the same elements (torch slices take
    positive steps only)."""
    out, flips = [], []
    for ax, (b, e, s) in enumerate(zip(_spec(begin, data.dim()),
                                       _spec(end, data.dim()),
                                       _spec(step, data.dim()))):
        if not s or s > 0:
            out.append(slice(b, e, s or None))
            continue
        idx = range(*slice(b, e, s).indices(data.shape[ax]))
        out.append(slice(idx[-1], idx[0] + 1, -s) if len(idx)
                   else slice(0, 0))
        flips.append(ax)
    return tuple(out), flips


@register("slice", aliases=("crop",))
def slice_op(data, begin=None, end=None, step=None):
    """``data[begin:end:step]`` per axis (negative steps included)."""
    idx, flips = _slices(data, begin, end, step)
    out = data[idx]
    return out.flip(flips) if flips else out


@register("_slice_assign", aliases=("_crop_assign",))
def slice_assign(lhs, rhs, begin=None, end=None, step=None):
    """A copy of ``lhs`` with ``lhs[begin:end:step] = rhs``."""
    idx, flips = _slices(lhs, begin, end, step)
    out = lhs.clone()
    rhs = rhs.to(lhs.dtype)
    out[idx] = rhs.flip(flips) if flips else rhs
    return out


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def slice_assign_scalar(data, scalar=0.0, begin=None, end=None, step=None):
    """A copy of ``data`` with a strided slice filled with ``scalar``."""
    idx, _ = _slices(data, begin, end, step)
    out = data.clone()
    out[idx] = parse_float(scalar, 0.0)
    return out


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    ax = parse_int(axis, 0) % data.dim()
    idx = [slice(None)] * data.dim()
    idx[ax] = slice(parse_int(begin, 0), parse_int(end))
    return data[tuple(idx)]


@register("slice_like")
def slice_like(data, shape_like, axes=None):
    axes = parse_tuple(axes) if axes else tuple(range(data.dim()))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a % data.dim()] = slice(0, shape_like.shape[a % data.dim()])
    return data[tuple(idx)]


@register("Concat", aliases=("concat", "_rnn_param_concat"), wrap_list=True)
def concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=parse_int(dim, 1))


@register("stack", wrap_list=True)
def stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=parse_int(axis, 0))


def _split(data, sections, ax, squeeze_axis):
    if data.shape[ax] % sections:
        raise ValueError(f"axis {ax} of size {data.shape[ax]} does not split "
                         f"into {sections} equal sections")
    parts = torch.tensor_split(data, sections, dim=ax)
    if parse_bool(squeeze_axis):
        parts = [p.squeeze(ax) for p in parts]
    return parts


@register("split", aliases=("SliceChannel",))
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``."""
    n = parse_int(num_outputs, 1)
    parts = _split(data, n, parse_int(axis, 1), squeeze_axis)
    return tuple(parts) if n > 1 else parts[0]


@register("split_v2", aliases=("_split_v2",))
def split_v2(data, indices_or_sections=None, axis=0, squeeze_axis=False,
             sections=0, indices=None):
    """An int: that many equal sections; a tuple: the split points."""
    ax = parse_int(axis, 0)
    if indices_or_sections is not None:
        if isinstance(indices_or_sections, (int, float, str)) and \
                str(indices_or_sections).lstrip("-").isdigit():
            sections = int(indices_or_sections)
        else:
            indices = indices_or_sections
    sections = parse_int(sections, 0)
    if sections:
        return tuple(_split(data, sections, ax, squeeze_axis))
    parts = torch.tensor_split(data, list(parse_tuple(indices)), dim=ax)
    if parse_bool(squeeze_axis):
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


@register("tile")
def tile(data, reps=None):
    return torch.tile(data, parse_tuple(reps))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(
        data, parse_int(repeats, 1),
        dim=parse_int(axis) if axis is not None else None)


@register("reverse", aliases=("flip",))
def reverse(data, axis=None):
    return torch.flip(data, parse_tuple(axis))


@register("Pad", aliases=("pad",))
def pad(data, mode="constant", pad_width=None, constant_value=0):
    """``pad_width`` is MXNet's flat (before, after) per axis, first axis
    first.  ``edge`` and ``reflect`` pad the spatial axes of 3-5-d data
    only, as MXNet's ``Pad`` does."""
    pw = parse_tuple(pad_width)
    flat = []
    for i in reversed(range(len(pw) // 2)):
        flat += [pw[2 * i], pw[2 * i + 1]]
    if mode == "constant":
        return F.pad(data, flat, value=float(constant_value))
    if mode not in ("edge", "reflect"):
        raise ValueError(f"unknown pad mode {mode}")
    if any(pw[:4]):
        raise ValueError(f"{mode} padding pads the spatial axes only, got "
                         f"pad_width {pw}")
    return F.pad(data, flat[:-4], mode="replicate" if mode == "edge"
                 else "reflect")


# ------------------------------------------------------------------ indexing
def _clip_index(idx, n, mode="clip"):
    idx = idx.long()
    if mode == "wrap":
        return torch.remainder(idx, n)
    return idx.clamp(0, n - 1)


@register("take")
def take(a, indices, axis=0, mode="clip"):
    """Rows of ``a`` along ``axis`` at ``indices`` (any shape)."""
    ax = parse_int(axis, 0) % a.dim()
    idx = _clip_index(indices, a.shape[ax], mode)
    out = torch.index_select(a, ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register("batch_take")
def batch_take(a, indices):
    idx = _clip_index(indices, a.shape[1])
    return torch.gather(a, 1, idx[:, None])[:, 0]


@register("Embedding", aliases=("_contrib_SparseEmbedding",))
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False):
    """Row gather (ids clipped into the table).  ``sparse_grad`` gives the
    dense gradient: the port has no row-sparse storage (ROADMAP.md)."""
    return _embedding(data, weight)


@register("one_hot")
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """Out-of-range indices give all ``off_value`` rows."""
    d = parse_int(depth)
    hot = indices.long().unsqueeze(-1) == torch.arange(d,
                                                       device=indices.device)
    on_v, off_v = float(on_value), float(off_value)
    out = hot.to(torch_dtype(dtype))
    if on_v != 1.0 or off_v != 0.0:
        out = out * (on_v - off_v) + off_v
    return out


def _nd_index(indices):
    idx = indices.long()
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd")
def gather_nd(data, indices):
    """``indices`` of shape (M, ...): its M leading rows address data's
    first M axes."""
    return data[_nd_index(indices)]


@register("scatter_nd")
def scatter_nd(data, indices, shape=None):
    out = torch.zeros(parse_tuple(shape), dtype=data.dtype,
                      device=data.device)
    return out.index_put(_nd_index(indices), data)


@register("_scatter_set_nd")
def scatter_set_nd(lhs, rhs, indices, shape=None):
    return lhs.index_put(_nd_index(indices), rhs)


@register("_backward_gather_nd", aliases=("scatter_nd_add",))
def gather_nd_backward(data, indices, shape=None):
    out = torch.zeros(parse_tuple(shape), dtype=data.dtype,
                      device=data.device)
    return out.index_put(_nd_index(indices), data, accumulate=True)


@register("boolean_mask", aliases=("_contrib_boolean_mask",))
def boolean_mask(data, index, axis=0):
    """The slices of ``axis`` where ``index`` is non-zero (a dynamic
    shape: it waits for the mask)."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, parse_int(axis, 0), keep)


# ----------------------------------------------------------------- products
@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    """Contract lhs's last axis with rhs's first (after optional
    transposes, which reverse all axes)."""
    a = lhs.permute(*reversed(range(lhs.dim()))) \
        if parse_bool(transpose_a) else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) \
        if parse_bool(transpose_b) else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
              forward_stype=None):
    """(B, M, K) x (B, K, N) -> (B, M, N)."""
    a = lhs.transpose(-1, -2) if parse_bool(transpose_a) else lhs
    b = rhs.transpose(-1, -2) if parse_bool(transpose_b) else rhs
    return torch.matmul(a, b)


@register("khatri_rao", wrap_list=True)
def khatri_rao(*args):
    """Column-wise Kronecker product."""
    a = args[0]
    for b in args[1:]:
        a = torch.einsum("ik,jk->ijk", a, b).reshape(-1, a.shape[1])
    return a


# ----------------------------------------------------------------- ordering
@register("sort")
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=parse_int(axis, -1), stable=True).values
    return out if parse_bool(is_ascend, True) else \
        out.flip(parse_int(axis, -1))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    key = data if parse_bool(is_ascend, True) else -data
    return torch.argsort(key, dim=parse_int(axis, -1), stable=True) \
        .to(torch_dtype(dtype))


@register("topk")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``; a
    tie goes to the lower index."""
    kk = parse_int(k, 1)
    if axis is None:
        data, ax = data.reshape(-1), 0
    else:
        ax = parse_int(axis, -1) % data.dim()
    key = -data if parse_bool(is_ascend) else data
    idx = torch.sort(key, dim=ax, descending=True, stable=True) \
        .indices.narrow(ax, 0, kk)
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(ax, idx, 1.0)
    vals = torch.gather(data, ax, idx)
    if ret_typ == "value":
        return vals
    idx = idx.to(torch_dtype(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "both":
        return vals, idx
    raise ValueError(f"unknown ret_typ {ret_typ}")


# --------------------------------------------------------------------- misc
@register("diag")
def diag(data, k=0, axis1=0, axis2=1):
    kk = parse_int(k, 0)
    if data.dim() == 1:
        return torch.diag(data, kk)
    return torch.diagonal(data, kk, parse_int(axis1, 0), parse_int(axis2, 1))


@register("histogram", aliases=("_histogram",))
def histogram(data, bins=None, bin_cnt=None, range=None):
    """``(counts, edges)`` as float32, numpy's rule: bins are half open but
    the last, which holds its right edge."""
    x = data.reshape(-1).float()
    if bins is not None and not isinstance(bins, (int, str)):
        edges = torch.as_tensor(bins, dtype=torch.float32, device=x.device) \
            .reshape(-1)
    else:
        cnt = parse_int(bin_cnt, 10)
        if range is not None:
            lo, hi = (float(v) for v in (ast.literal_eval(range)
                                         if isinstance(range, str)
                                         else range))
        else:
            lo, hi = float(x.min()), float(x.max())
        edges = torch.linspace(lo, hi, cnt + 1, device=x.device)
    n = edges.numel() - 1
    idx = torch.bucketize(x, edges, right=True) - 1
    idx = torch.where(x == edges[-1], n - 1, idx)
    keep = (idx >= 0) & (idx < n)
    counts = torch.bincount(idx[keep], minlength=n).float()
    return counts, edges


@register("ravel_multi_index", aliases=("_ravel_multi_index",))
def ravel_multi_index(data, shape=None):
    idx = data.long()
    out = torch.zeros(idx.shape[1:], dtype=torch.int64, device=data.device)
    for i, s in enumerate(parse_tuple(shape)):
        out = out * s + idx[i]
    return out.to(data.dtype)


@register("unravel_index", aliases=("_unravel_index",))
def unravel_index(data, shape=None):
    rem = data.long()
    outs = []
    for s in reversed(parse_tuple(shape)):
        outs.append(torch.remainder(rem, s))
        rem = torch.div(rem, s, rounding_mode="floor")
    return torch.stack(outs[::-1], dim=0).to(data.dtype)


def _positions(data, ax, lens):
    """(seq positions, lengths) shaped to broadcast against ``data`` whose
    sequence axis is ``ax`` (0 or 1) and batch axis the other."""
    pos_shape = [1] * data.dim()
    pos_shape[ax] = data.shape[ax]
    len_shape = [1] * data.dim()
    len_shape[1 - ax] = data.shape[1 - ax]
    pos = torch.arange(data.shape[ax], device=data.device).reshape(pos_shape)
    return pos, lens.long().reshape(len_shape)


@register("SequenceMask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Positions at or past each sequence's length set to ``value``."""
    if not parse_bool(use_sequence_length) or sequence_length is None:
        return data.clone()
    pos, lens = _positions(data, parse_int(axis, 0), sequence_length)
    return torch.where(pos < lens, data,
                       torch.tensor(float(value), dtype=data.dtype,
                                    device=data.device))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    ax = parse_int(axis, 0)
    if not parse_bool(use_sequence_length) or sequence_length is None:
        return data.select(ax, data.shape[ax] - 1)
    moved = data.movedim(ax, 0)                       # (seq, batch, ...)
    idx = (sequence_length.long() - 1).reshape(
        (1, -1) + (1,) * (moved.dim() - 2)).expand((1,) + moved.shape[1:])
    return torch.gather(moved, 0, idx)[0]


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    ax = parse_int(axis, 0)
    if not parse_bool(use_sequence_length) or sequence_length is None:
        return data.flip(ax)
    moved = data.movedim(ax, 0)
    pos = torch.arange(moved.shape[0], device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    rev = torch.where(pos < lens, lens - 1 - pos, pos)
    rev = rev.reshape(rev.shape + (1,) * (moved.dim() - 2)).expand(
        moved.shape)
    return torch.gather(moved, 0, rev).movedim(0, ax)
