"""Image operators behind ``mx.nd.image``, ``mx.image`` and
``gluon.data.vision.transforms`` (the port's counterpart of
``mxnet_tpu/ops/image_ops.py``; MXNet's ``src/operator/image/``).

HWC (or NHWC) uint8/float inputs, as in MXNet.  The random ops take
``generator=``, the ``torch.Generator`` of their input's device, which
``ndarray/register.py`` passes (``mx.random.seed`` resets it); the JAX
package draws from ``jax.random`` keys, so the two agree by distribution
and, with a degenerate range, exactly.

``image_augment`` is the device prologue of ``ImageRecordIter(
device_augment=True)``: per-image crop, mirror, normalise and widen to
float32 of a uint8 CHW batch, written as one gather over computed indices
(no loop over images) and one fused-by-torch elementwise chain.
"""
from __future__ import annotations

import ast
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import parse_bool, parse_float, parse_int, parse_tuple
from .random_ops import _register_random
from .registry import register

_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))
_TYIQ = ((0.299, 0.587, 0.114),
         (0.596, -0.274, -0.321),
         (0.211, -0.523, 0.311))
_ITYIQ = ((1.0, 0.956, 0.621),
          (1.0, -0.272, -0.647),
          (1.0, -1.107, 1.705))


def _f32(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


@register("_image_to_tensor", aliases=("image_to_tensor", "to_tensor"))
def to_tensor(data):
    """HWC [0,255] -> CHW [0,1] float32 (reference image_random-inl.h)."""
    x = data.to(torch.float32) / 255.0
    if data.dim() == 3:
        return x.permute(2, 0, 1).contiguous()
    return x.permute(0, 3, 1, 2).contiguous()


def _ftuple(v, default=(0.0,)):
    if v is None:
        return default
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


@register("_image_normalize", aliases=("image_normalize",))
def normalize(data, mean=None, std=None):
    """(x - mean) / std per channel of a CHW or NCHW input; a short mean or
    std repeats, as ``jnp.resize`` repeats it."""
    c = data.shape[0] if data.dim() == 3 else data.shape[1]
    mean_a = _f32(np.resize(_ftuple(mean, (0.0,)), c).tolist(), data.device)
    std_a = _f32(np.resize(_ftuple(std, (1.0,)), c).tolist(), data.device)
    shape = (c, 1, 1) if data.dim() == 3 else (1, c, 1, 1)
    return (data - mean_a.reshape(shape)) / std_a.reshape(shape)


@register("_image_resize", aliases=("image_resize",))
def resize(data, size=None, keep_ratio=False, interp=1):
    """Reference ``image.resize`` (resize-inl.h); HWC or NHWC.  Bilinear
    with antialiasing when shrinking and half-pixel nearest, as
    ``jax.image.resize`` computes them; an integer input is truncated back
    to its type."""
    sz = parse_tuple(size)
    ih, iw = (data.shape[0], data.shape[1]) if data.dim() == 3 \
        else (data.shape[1], data.shape[2])
    if len(sz) == 1:
        if parse_bool(keep_ratio):
            # shorter side -> size, keeping the aspect ratio
            if ih < iw:
                sz = (int(round(iw * sz[0] / ih)), sz[0])
            else:
                sz = (sz[0], int(round(ih * sz[0] / iw)))
        else:
            sz = (sz[0], sz[0])
    w, h = sz  # MXNet size is (w, h)
    x = data.to(torch.float32)
    x = x.permute(2, 0, 1)[None] if data.dim() == 3 else x.permute(0, 3, 1, 2)
    if parse_int(interp, 1) != 0:
        out = F.interpolate(x, size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)
    else:
        out = F.interpolate(x, size=(h, w), mode="nearest-exact")
    out = out[0].permute(1, 2, 0) if data.dim() == 3 \
        else out.permute(0, 2, 3, 1)
    out = out.contiguous()
    if not data.dtype.is_floating_point:
        return out.to(data.dtype)
    return out


@register("_image_augment", aliases=("image_augment",))
def image_augment(data, flip, crop_xy, out_h=None, out_w=None,
                  mean_r=0.0, mean_g=0.0, mean_b=0.0,
                  std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                  rand_crop=False):
    """The training-augmentation prologue on the device: per-image crop,
    mirror, normalise and widen to float32 of a (N, 3, H, W) uint8 (or
    float) canvas batch (``image_aug_default.cc``'s work, off the host).

    ``flip``: (N,) mirror flags; ``crop_xy``: (N, 2) crop-offset fractions
    in [0, 1), used when ``rand_crop`` (else the centre, the host path's
    integer arithmetic).  The offsets are ``floor(frac * (ih - oh + 1))``
    in float32, the JAX package's arithmetic.  The crop and the mirror are
    one ``gather`` of the flattened pixels at computed indices."""
    oh, ow = parse_int(out_h), parse_int(out_w)
    n, c, ih, iw = data.shape
    dev = data.device
    flip = flip.to(dev).reshape(-1).to(torch.bool)
    if (oh, ow) != (ih, iw) and parse_bool(rand_crop):
        crop_xy = crop_xy.to(device=dev, dtype=torch.float32)
        y0 = torch.floor(crop_xy[:, 0] * (ih - oh + 1)).to(torch.int64)
        x0 = torch.floor(crop_xy[:, 1] * (iw - ow + 1)).to(torch.int64)
    else:
        y0 = torch.full((n,), (ih - oh) // 2, dtype=torch.int64, device=dev)
        x0 = torch.full((n,), (iw - ow) // 2, dtype=torch.int64, device=dev)
    cols = torch.arange(ow, device=dev)
    cols = torch.where(flip[:, None], ow - 1 - cols, cols)      # (N, ow)
    rows = torch.arange(oh, device=dev)
    index = (y0[:, None, None] + rows[None, :, None]) * iw \
        + (x0[:, None, None] + cols[:, None, :])                  # (N,oh,ow)
    index = index.reshape(n, 1, oh * ow).expand(n, c, oh * ow)
    x = torch.gather(data.reshape(n, c, ih * iw), 2, index)
    x = x.reshape(n, c, oh, ow).to(torch.float32)
    mean = _f32([parse_float(mean_r, 0.0), parse_float(mean_g, 0.0),
                 parse_float(mean_b, 0.0)], dev)
    std = _f32([parse_float(std_r, 1.0), parse_float(std_g, 1.0),
                parse_float(std_b, 1.0)], dev)
    return (x - mean[:, None, None]) / std[:, None, None] \
        * parse_float(scale, 1.0)


@register("_image_crop", aliases=("image_crop",))
def crop(data, x=0, y=0, width=1, height=1):
    xx, yy = parse_int(x, 0), parse_int(y, 0)
    w, h = parse_int(width), parse_int(height)
    if data.dim() == 3:
        return data[yy:yy + h, xx:xx + w, :]
    return data[:, yy:yy + h, xx:xx + w, :]


@register("_image_flip_left_right", aliases=("image_flip_left_right",))
def flip_left_right(data):
    return torch.flip(data, (-2,))


@register("_image_flip_top_bottom", aliases=("image_flip_top_bottom",))
def flip_top_bottom(data):
    return torch.flip(data, (-3,))


def _uniform(generator, device, lo, hi):
    u = torch.rand((), generator=generator, device=device)
    return u * (hi - lo) + lo


def _coin(generator, device):
    return bool(torch.rand((), generator=generator, device=device) < 0.5)


@_register_random("_image_random_flip_left_right",
                  aliases=("image_random_flip_left_right",))
def random_flip_left_right(data, generator=None):
    return torch.flip(data, (-2,)) if _coin(generator, data.device) \
        else data.clone()


@_register_random("_image_random_flip_top_bottom",
                  aliases=("image_random_flip_top_bottom",))
def random_flip_top_bottom(data, generator=None):
    return torch.flip(data, (-3,)) if _coin(generator, data.device) \
        else data.clone()


@_register_random("_image_random_brightness",
                  aliases=("image_random_brightness",))
def random_brightness(data, min_factor=0.0, max_factor=0.0, generator=None):
    f = _uniform(generator, data.device, parse_float(min_factor, 0.0),
                 parse_float(max_factor, 0.0))
    return data * f


@_register_random("_image_random_contrast",
                  aliases=("image_random_contrast",))
def random_contrast(data, min_factor=0.0, max_factor=0.0, generator=None):
    f = _uniform(generator, data.device, parse_float(min_factor, 0.0),
                 parse_float(max_factor, 0.0))
    gray = data.to(torch.float32).mean(dim=(-3, -2, -1), keepdim=True)
    return f * data + (1 - f) * gray


@_register_random("_image_random_saturation",
                  aliases=("image_random_saturation",))
def random_saturation(data, min_factor=0.0, max_factor=0.0, generator=None):
    f = _uniform(generator, data.device, parse_float(min_factor, 0.0),
                 parse_float(max_factor, 0.0))
    coef = _f32([0.299, 0.587, 0.114], data.device)
    gray = (data.to(torch.float32) * coef).sum(dim=-1, keepdim=True)
    return f * data + (1 - f) * gray


def _hue_matrix(f, device):
    """The YIQ hue rotation by ``f`` half-turns (a 0-dim tensor)."""
    alpha, beta = torch.cos(f * math.pi), torch.sin(f * math.pi)
    zero, one = torch.zeros((), device=device), torch.ones((), device=device)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, alpha, -beta]),
                       torch.stack([zero, beta, alpha])])
    return _f32(_ITYIQ, device) @ rot @ _f32(_TYIQ, device)


@_register_random("_image_random_hue", aliases=("image_random_hue",))
def random_hue(data, min_factor=0.0, max_factor=0.0, generator=None):
    """Hue rotation in YIQ space (reference image_random-inl.h RandomHue)."""
    f = _uniform(generator, data.device, parse_float(min_factor, 0.0),
                 parse_float(max_factor, 0.0))
    return data.to(torch.float32) @ _hue_matrix(f, data.device).T


def _lighting(data, alpha):
    delta = (_f32(_EIGVEC, data.device) * alpha) @ _f32(_EIGVAL, data.device)
    return data + delta


@_register_random("_image_random_lighting",
                  aliases=("image_random_lighting",))
def random_lighting(data, alpha_std=0.05, generator=None):
    """AlexNet-style PCA lighting with gaussian alpha (reference
    RandomLighting)."""
    a = torch.randn(3, generator=generator, device=data.device) \
        * parse_float(alpha_std, 0.05)
    return _lighting(data, a)


@_register_random("_image_random_color_jitter",
                  aliases=("image_random_color_jitter",))
def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0, generator=None):
    """Brightness, contrast, saturation and hue jitter in that order
    (reference RandomColorJitter); each draws only when its amount is
    positive."""
    b = parse_float(brightness, 0.0)
    c = parse_float(contrast, 0.0)
    s = parse_float(saturation, 0.0)
    h = parse_float(hue, 0.0)
    out = data.to(torch.float32)
    if b > 0:
        out = random_brightness(out, max(0.0, 1 - b), 1 + b, generator)
    if c > 0:
        out = random_contrast(out, max(0.0, 1 - c), 1 + c, generator)
    if s > 0:
        out = random_saturation(out, max(0.0, 1 - s), 1 + s, generator)
    if h > 0:
        out = random_hue(out, -h, h, generator)
    return out


@register("_image_adjust_lighting", aliases=("image_adjust_lighting",))
def adjust_lighting(data, alpha=None):
    """AlexNet-style PCA lighting with a given alpha (reference
    image_random-inl.h)."""
    return _lighting(data, _f32(_ftuple(alpha), data.device))
