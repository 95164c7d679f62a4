"""The detection operators of ``mx.nd.contrib`` (counterpart of
``mxnet_tpu/ops/contrib_ops.py:35-311``; reference
``src/operator/contrib/bounding_box.cc`` and ``multibox_*.cc``):
``box_iou``, ``box_nms``, ``bipartite_matching``, ``MultiBoxPrior``,
``MultiBoxTarget`` and ``MultiBoxDetection``.

The JAX package vmaps each over the batch; here the batch is an axis.
Greedy NMS runs in :func:`ops.nms.greedy_nms`: the hand-written kernel on
a CUDA tensor, the literal loop on a CPU one.  Sorts are stable
(``jnp.argsort`` is), so rows of equal score keep their order, the
thousands of background rows at -1 included.

Gradients.  ``box_iou`` and ``box_nms`` take torch's autograd, as the JAX
package takes ``jax.vjp``.  ``MultiBoxPrior`` depends on its input's shape
alone: its gradient is zero (it stays on the tape, so that a head computed
from it can be differentiated).  ``MultiBoxTarget`` and
``MultiBoxDetection`` give no gradient, as MXNet 1.5's backward writes
zeros: training never differentiates the targets, and computing them off
the tape keeps the anchors' arithmetic out of the backward pass.

``MultiBoxTarget`` departs from the JAX package in one case, a defect of
the reference side: there a padded label row (class -1) scatters its
``valid = False`` onto anchor 0 and can erase a real box's forced match
there, depending on the order of the scatter's updates
(``mxnet_tpu/ops/contrib_ops.py:223-227``).  MXNet 1.5 skips padded rows;
so does the port.  Among real boxes that share a best anchor the later
one wins, as XLA's scatter on the CPU resolves it, here by a maximum over
the box index, which does not depend on the order of any update.
"""
from __future__ import annotations

import ast
import functools

import torch

from ..base import parse_bool, parse_float, parse_int
from .nms import greedy_nms, iou_corner
from .registry import register


def _ftuple(v, default=()):
    if v is None:
        return default
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _to_corner(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _greedy_nms_mask(boxes, valid, thresh, force=False, cls_id=None,
                     topk=-1):
    """Greedy NMS over score-sorted ``(B, n, 4)`` boxes: the keep mask
    ``(B, n)``; ``cls_id`` restricts suppression to equal ids unless
    ``force``."""
    return greedy_nms(boxes, valid, thresh,
                      None if force or cls_id is None else cls_id, topk)


def _sorted_by_score(score, *tensors):
    """``tensors`` (each ``(B, n, ...)``) gathered in the order of a stable
    descending sort of ``score (B, n)``."""
    order = torch.sort(-score, dim=-1, stable=True).indices
    out = []
    for t in tensors:
        idx = order.reshape(order.shape + (1,) * (t.dim() - 2))
        out.append(torch.gather(t, 1, idx.expand(t.shape)))
    return out


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner"):
    a = lhs if format == "corner" else _to_corner(lhs)
    b = rhs if format == "corner" else _to_corner(rhs)
    return iou_corner(a, b)


@register("_contrib_box_nms", aliases=("box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """``box_nms`` (bounding_box.cc): rows ``[id?, score, x1, y1, x2,
    y2, ...]`` of ``(..., N, K)`` data, sorted by score, the suppressed
    and invalid ones -1."""
    thr = parse_float(overlap_thresh, 0.5)
    vthr = parse_float(valid_thresh, 0.0)
    cs, si = parse_int(coord_start, 2), parse_int(score_index, 1)
    ii = parse_int(id_index, -1)
    bg = parse_float(background_id, -1)
    force = parse_bool(force_suppress)
    k = parse_int(topk, -1)
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    scores = flat[..., si]
    boxes = flat[..., cs:cs + 4]
    if in_format == "center":
        boxes = _to_corner(boxes)
    valid = scores > vthr
    if ii >= 0:
        valid = valid & (flat[..., ii] != bg)
    rows, b_sorted, v_sorted = _sorted_by_score(scores, flat, boxes, valid)
    keep = _greedy_nms_mask(b_sorted, v_sorted, thr, force=force,
                            cls_id=rows[..., ii] if ii >= 0 else None,
                            topk=k)
    out = torch.where(keep[..., None], rows, -torch.ones_like(rows))
    return out.reshape(shape)


def _bipartite_one(mat, thr, asc):
    m, n = mat.shape
    score = -mat if asc else mat
    row_match = torch.full((m,), -1, dtype=torch.int64, device=mat.device)
    col_used = torch.zeros((n,), dtype=torch.bool, device=mat.device)
    limit = -thr if asc else thr
    for _ in range(min(m, n)):
        blocked = col_used[None, :] | (row_match >= 0)[:, None]
        flat = torch.argmax(torch.where(blocked, -torch.inf, score))
        r, c = divmod(int(flat), n)
        if score[r, c] > limit:
            row_match[r] = c
            col_used[c] = True
    return (row_match.to(mat.dtype),
            torch.where(col_used, 1.0, -1.0).to(mat.dtype))


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",))
def bipartite_matching(data, is_ascend=False, threshold=0.5, topk=-1):
    """Greedy bipartite matching (bounding_box.cc): ``min(m, n)`` steps,
    each taking the best unmatched (row, column) above the threshold."""
    thr = parse_float(threshold, 0.5)
    asc = parse_bool(is_ascend)
    with torch.no_grad():
        if data.dim() == 2:
            return _bipartite_one(data, thr, asc)
        rows, cols = zip(*(_bipartite_one(d, thr, asc) for d in data))
        return torch.stack(rows), torch.stack(cols)


class _ShapeOnly(torch.autograd.Function):
    """``out``, recorded as a function of ``data`` with a zero gradient."""

    @staticmethod
    def forward(ctx, data, out):
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, None


@functools.lru_cache(maxsize=256)
def _prior(h, w, szs, rts, stps, offs, clip, device):
    """The anchors of an (h, w) map on ``device``, made there once and kept
    (they depend on the map's shape alone): later calls copy them on the
    device instead of launching a dozen small kernels and a host copy of
    the sizes, which waits for the stream."""
    step_y = stps[0] if stps[0] > 0 else 1.0 / h
    step_x = stps[1] if stps[1] > 0 else 1.0 / w
    with torch.inference_mode(False), torch.no_grad():
        cy = (torch.arange(h, dtype=torch.float32, device=device) + offs[0]) \
            * step_y
        cx = (torch.arange(w, dtype=torch.float32, device=device) + offs[1]) \
            * step_x
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        centers = torch.stack([cxg, cyg], dim=-1).reshape(-1, 2)
        whs = [(s * (rts[0] ** 0.5), s / (rts[0] ** 0.5)) for s in szs]
        whs += [(szs[0] * (r ** 0.5), szs[0] / (r ** 0.5)) for r in rts[1:]]
        half = torch.tensor(whs, dtype=torch.float32, device=device) / 2
        c = centers[:, None, :]
        boxes = torch.cat([c - half, c + half], dim=-1).reshape(1, -1, 4)
        return boxes.clamp(0.0, 1.0) if clip else boxes


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def multibox_prior(data, sizes="(1,)", ratios="(1,)", clip=False,
                   steps="(-1,-1)", offsets="(0.5, 0.5)"):
    """``MultiBoxPrior`` (multibox_prior.cc): the anchors of an (N, C, H,
    W) feature map, ``(1, H*W*A, 4)`` corners; centres in (x, y) over an
    ``ij`` grid, the sizes at the first ratio, then the other ratios at
    the first size."""
    boxes = _prior(data.shape[2], data.shape[3], _ftuple(sizes, (1.0,)),
                   _ftuple(ratios, (1.0,)), _ftuple(steps, (-1.0, -1.0)),
                   _ftuple(offsets, (0.5, 0.5)), parse_bool(clip),
                   data.device).clone()
    if data.requires_grad and torch.is_grad_enabled():
        boxes = _ShapeOnly.apply(data, boxes)
    return boxes


def _anchor_geometry(anchor):
    anchors = anchor.reshape(-1, 4)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    return anchors, aw, ah, acx, acy


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",))
@torch.no_grad()
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances="(0.1, 0.1, 0.2, 0.2)"):
    """``MultiBoxTarget`` (multibox_target.cc): anchor (1, A, 4) corners,
    label (B, M, 5) ``[cls, x1, y1, x2, y2]`` padded with rows of -1,
    cls_pred (B, classes + 1, A).  Returns loc_target (B, A*4), loc_mask
    (B, A*4) and cls_target (B, A)."""
    thr = parse_float(overlap_threshold, 0.5)
    var = _ftuple(variances, (0.1, 0.1, 0.2, 0.2))
    nmr = parse_float(negative_mining_ratio, -1.0)
    nmt = parse_float(negative_mining_thresh, 0.5)
    anchors, aw, ah, acx, acy = _anchor_geometry(anchor)
    n_anchor, n_gt = anchors.shape[0], label.shape[1]
    dev = anchors.device
    valid_gt = label[..., 0] >= 0                              # (B, M)
    gt_boxes = label[..., 1:5]
    iou = iou_corner(anchors[None], gt_boxes)                 # (B, A, M)
    iou = torch.where(valid_gt[:, None, :], iou, -1.0)
    best_gt = iou.argmax(dim=2)
    best_iou = iou.amax(dim=2)
    # each real box forces a match on its best anchor; padded rows never
    # write, and of real boxes sharing an anchor the last one wins
    best_anchor = iou.argmax(dim=1)                            # (B, M)
    hit = (best_anchor[:, :, None] ==
           torch.arange(n_anchor, device=dev)) & valid_gt[:, :, None]
    forced = hit.any(dim=1)
    gt_index = torch.arange(n_gt, device=dev)[None, :, None]
    forced_gt = torch.where(hit, gt_index, -1).amax(dim=1)
    matched = forced | (best_iou >= thr)
    match_gt = torch.where(forced, forced_gt, best_gt)
    gt = torch.gather(gt_boxes, 1, match_gt[..., None].expand(-1, -1, 4))
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    gw = torch.clamp_min(gt[..., 2] - gt[..., 0], 1e-8)
    gh = torch.clamp_min(gt[..., 3] - gt[..., 1], 1e-8)
    aw, ah = torch.clamp_min(aw, 1e-8), torch.clamp_min(ah, 1e-8)
    loc_t = torch.stack([(gcx - acx) / aw / var[0], (gcy - acy) / ah / var[1],
                         torch.log(gw / aw) / var[2],
                         torch.log(gh / ah) / var[3]], dim=-1)
    loc_t = torch.where(matched[..., None], loc_t, 0.0)
    loc_m = matched[..., None].expand(loc_t.shape).to(loc_t.dtype)
    gt_cls = torch.gather(label[..., 0], 1, match_gt)
    cls_t = torch.where(matched, gt_cls + 1, 0.0)
    if nmr > 0:
        # hard negatives: unmatched anchors below nmt, ranked by how little
        # background probability they are given
        bg_prob = torch.softmax(cls_pred, dim=1)[:, 0]
        neg_cand = ~matched & (best_iou < nmt)
        num_neg = torch.clamp_min(
            matched.sum(dim=1) * nmr,
            float(parse_int(minimum_negative_samples, 0)))
        score = torch.where(neg_cand, 1.0 - bg_prob, -1.0)
        order = torch.sort(-score, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n_anchor, device=dev).expand_as(order))
        selected = neg_cand & (rank < num_neg[:, None])
        cls_t = torch.where(
            selected, 0.0,
            torch.where(matched, cls_t, parse_float(ignore_label, -1.0)))
    return loc_t.reshape(loc_t.shape[0], -1), \
        loc_m.reshape(loc_m.shape[0], -1), cls_t


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",))
@torch.no_grad()
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances="(0.1, 0.1, 0.2, 0.2)", nms_topk=-1):
    """``MultiBoxDetection`` (multibox_detection.cc): decode loc_pred (B,
    A*4) against the anchors (1, A, 4), take each anchor's best foreground
    class of cls_prob (B, classes + 1, A), sort by its score and run NMS.
    Output (B, A, 6) ``[cls_id, score, x1, y1, x2, y2]``, the suppressed
    and invalid rows -1."""
    var = _ftuple(variances, (0.1, 0.1, 0.2, 0.2))
    thr = parse_float(threshold, 0.01)
    nthr = parse_float(nms_threshold, 0.5)
    bg = parse_int(background_id, 0)
    _, aw, ah, acx, acy = _anchor_geometry(anchor)
    loc = loc_pred.reshape(cls_prob.shape[0], -1, 4)
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if parse_bool(clip, True):
        boxes = boxes.clamp(0.0, 1.0)
    fg_mask = torch.arange(cls_prob.shape[1], device=cls_prob.device) != bg
    fg = torch.where(fg_mask[:, None], cls_prob, -1.0)
    cls_id = fg.argmax(dim=1)
    score = fg.amax(dim=1)
    valid = score > thr
    out_id = torch.where(valid, (cls_id - (1 if bg == 0 else 0)).to(
        torch.float32), -1.0)
    rows = torch.cat([out_id[..., None], score[..., None], boxes], dim=-1)
    rows_s, v_sorted = _sorted_by_score(score, rows, valid)
    keep = _greedy_nms_mask(rows_s[..., 2:6], v_sorted, nthr,
                            force=parse_bool(force_suppress),
                            cls_id=rows_s[..., 0],
                            topk=parse_int(nms_topk, -1))
    return torch.where(keep[..., None], rows_s, -torch.ones_like(rows_s))
