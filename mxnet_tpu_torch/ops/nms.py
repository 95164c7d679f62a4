"""Greedy non-maximum suppression: a hand-written Hopper kernel and its
plain version.

The port's own kernel (no TPU counterpart): the JAX package's
``_greedy_nms_mask`` (``mxnet_tpu/ops/contrib_ops.py:66-81``) is a
``lax.fori_loop`` over every score-sorted row, compiled by XLA; ``box_nms``
and ``MultiBoxDetection`` run it (``ops/contrib_ops.py``).  On the card a
torch loop would launch a chain of small kernels a row, so
:func:`greedy_nms` launches ``csrc/nms.cu``: a pass that writes, for every
pair of 64-row tiles, which rows each row would remove (64-bit words), and
a scan, one block an image, that walks the rows in order against a removal
bitmap in shared memory (see the source).  Its IoU is rounded as
:func:`iou_corner` rounds it, so the keep mask equals the plain version's
bit for bit.

On a CUDA tensor :func:`greedy_nms` launches the kernel or raises; it never
falls back.  On a CPU tensor it runs :func:`_reference`, the literal loop
of ``_greedy_nms_mask``, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against.  The rows past ``topk`` are
invalid and remove nothing, so the wrapper hands either version the first
``min(n, topk)`` rows only.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["greedy_nms", "iou_corner"]

_lib = None


def iou_corner(a, b):
    """IoU between ``(..., M, 4)`` and ``(..., N, 4)`` corner boxes ->
    ``(..., M, N)`` (``mxnet_tpu/ops/contrib_ops.py:37``): the intersection
    and the areas clamped at 0, ``inter / union`` where the union is
    positive, else 0.  ``torch.maximum``/``minimum`` split a tie's gradient
    as ``jnp.maximum`` does."""
    zero = a.new_zeros(())
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = torch.maximum(ix2 - ix1, zero) * torch.maximum(iy2 - iy1, zero)
    area_a = torch.maximum((ax2 - ax1) * (ay2 - ay1), zero)
    area_b = torch.maximum((bx2 - bx1) * (by2 - by1), zero)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, zero)


def _reference(boxes, valid, thresh, cls_id=None):
    """The literal loop of ``_greedy_nms_mask`` over a batch: row ``i``,
    when valid and not yet removed, removes every other valid row whose
    IoU with it (0 across class ids, when given) exceeds ``thresh``."""
    iou = iou_corner(boxes, boxes)
    if cls_id is not None:
        iou = torch.where(cls_id[:, :, None] == cls_id[:, None, :], iou, 0.0)
    over = (iou > thresh) & valid[:, None, :]
    over.diagonal(dim1=1, dim2=2).fill_(False)
    removed = torch.zeros_like(valid)
    for i in range(valid.shape[1]):
        alive = valid[:, i] & ~removed[:, i]
        removed |= over[:, i] & alive[:, None]
    return valid & ~removed


def _launch(boxes, valid, thresh, cls_id):
    """Both passes on ``boxes``' device and current stream."""
    global _lib
    dev = boxes.device
    if dev.type != "cuda" or valid.device != dev or \
            (cls_id is not None and cls_id.device != dev):
        raise ValueError(f"boxes, valid and cls_id must lie on one CUDA "
                         f"device or all on the CPU, got {boxes.device}, "
                         f"{valid.device}"
                         f"{'' if cls_id is None else f', {cls_id.device}'}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool or \
            (cls_id is not None and cls_id.dtype != torch.float32):
        raise TypeError(f"greedy_nms takes float32 boxes and ids and a bool "
                        f"mask, got {boxes.dtype}, {valid.dtype}"
                        f"{'' if cls_id is None else f', {cls_id.dtype}'}")
    b, n = valid.shape
    words = (n + 63) // 64
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    cls_id = None if cls_id is None else cls_id.contiguous()
    keep = torch.empty((b, n), dtype=torch.bool, device=dev)
    mask = torch.empty((b, n, words), dtype=torch.int64, device=dev)
    device = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if _lib is None:
        _lib = _build.load()
    rc = _lib.mxt_nms(boxes.data_ptr(), valid.data_ptr(),
                      None if cls_id is None else cls_id.data_ptr(),
                      float(thresh), b, n, mask.data_ptr(), mask.numel(),
                      keep.data_ptr(), device, _build.raw_stream(device))
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: "
                           f"{_lib.mxt_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    return keep


def greedy_nms(boxes, valid, thresh, cls_id=None, topk=-1):
    """Keep mask ``(B, n)`` bool of greedy NMS over score-sorted corner
    ``boxes (B, n, 4)`` fp32 with ``valid (B, n)`` bool and, unless
    suppression is forced across classes, ``cls_id (B, n)`` fp32: a row is
    kept when it is valid and no kept row before it overlaps it by more
    than ``thresh``.  ``topk > 0`` makes the rows past ``topk`` invalid.
    ``greedy_nms.launches`` counts kernel launches (one a call, two
    kernels each; CPU calls are not counted)."""
    b, n = valid.shape
    k = n if topk is None or topk <= 0 else min(n, int(topk))
    if k < n:
        boxes, valid = boxes[:, :k], valid[:, :k]
        cls_id = None if cls_id is None else cls_id[:, :k]
    if boxes.device.type == "meta":            # shape inference
        keep = torch.empty_like(valid)
    elif boxes.device.type == "cpu" and valid.device.type == "cpu":
        keep = _reference(boxes, valid, thresh, cls_id)
    else:
        keep = _launch(boxes, valid, thresh, cls_id)
        greedy_nms.launches += 1
    if k < n:
        keep = torch.cat([keep, keep.new_zeros((b, n - k))], dim=1)
    return keep


greedy_nms.launches = 0
