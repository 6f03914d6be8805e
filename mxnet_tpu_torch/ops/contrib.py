"""Detection ops of the PyTorch port: box IoU, NMS and SSD's MultiBox family.

Counterparts of ``mxnet_tpu/ops/contrib.py:26-275`` (reference:
src/operator/contrib/bounding_box.cc, multibox_prior.cc,
multibox_target.cc, multibox_detection.cc), registered under the JAX
package's names and aliases, with its semantics rather than upstream
C++'s where the two differ: every shape is fixed (``box_nms`` keeps all N
rows, a suppressed one with score -1), ``MultiBoxPrior`` orders an
anchor's shapes as all sizes at ``ratios[0]`` then the other ratios at
``sizes[0]``, ``MultiBoxTarget`` claims anchors through an (M, N) claim
matrix and mines hard negatives by a stable sort of the background
probability, and ``MultiBoxDetection`` sets a suppressed row's class to
-1.  Every sort is stable, as ``jnp.argsort`` is, so ties (the many rows
of score -1) come out in the JAX package's order.

The ops are batched over the images where the JAX package ``vmap``s.
NMS's greedy loop is the port's kernel K7 on the card
(:mod:`.box_nms`); the rest is plain PyTorch.  ``MultiBoxPrior`` and
``MultiBoxTarget`` return tensors that carry no gradient.
"""

from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .box_nms import corner_iou, nms_keep
from .registry import register

__all__ = ["box_iou", "box_nms", "nms_inputs", "multibox_prior",
           "multibox_target", "multibox_detection"]


def _center_to_corner(b):
    x, y, w, h = b.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


@register("box_iou", aliases=("_contrib_box_iou",))
def box_iou(lhs, rhs, format="corner", **_):
    """IoU of every box of ``lhs`` (..., M, 4) with every box of ``rhs``
    (..., N, 4), in ``"corner"`` (x1, y1, x2, y2) or ``"center"`` (x, y,
    w, h) format -> (..., M, N)."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    elif format != "corner":
        raise MXNetError("box_iou: format must be corner or center, not %r"
                         % (format,))
    return corner_iou(lhs, rhs)


@register("box_nms", aliases=("_contrib_box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner",
            **_):
    """Fixed-capacity greedy NMS of ``data`` (..., N, K) rows [id?, score,
    x1, y1, x2, y2, ...]: each image's rows sorted by score, descending
    (stable), and the score of each row suppressed or not valid (score
    at most ``valid_thresh``, or rank ``topk`` or later) set to -1.  A
    row suppresses the later rows whose IoU is above ``overlap_thresh``
    and whose ``id_index`` column equals its own (any row with
    ``force_suppress`` or ``id_index < 0``).  ``background_id`` and
    ``out_format`` are accepted and, as in the JAX package, ignored."""
    del background_id, out_format
    si, topk = int(score_index), int(topk)
    rows, boxes, n_valid, ids = nms_inputs(
        data, valid_thresh, topk, coord_start, si, id_index, force_suppress,
        in_format)
    keep = nms_keep(boxes, n_valid, overlap_thresh, ids, topk)
    scores = rows[:, :, si]
    new_scores = torch.where(keep, scores, torch.full_like(scores, -1.0))
    out = torch.cat([rows[:, :, :si], new_scores.unsqueeze(-1),
                     rows[:, :, si + 1:]], dim=-1)
    return out.reshape(data.shape)


def nms_inputs(data, valid_thresh=0.0, topk=-1, coord_start=2,
               score_index=1, id_index=-1, force_suppress=False,
               in_format="corner"):
    """What :func:`box_nms` hands K7 (:func:`~.box_nms.nms_keep`): each
    image's rows (B, N, K), ``data`` flattened to images, sorted by
    score, descending, by a stable sort; their corner boxes (B, N, 4)
    float32; the count of valid rows of each image (score above
    ``valid_thresh``, rank below ``topk``: a prefix, as the scores
    descend); the class ids (B, N) float32, or None when every row may
    suppress every other."""
    cs, si, ii = int(coord_start), int(score_index), int(id_index)
    n, k = data.shape[-2], data.shape[-1]
    flat = data.reshape(-1, n, k)
    order = torch.sort(-flat[:, :, si], dim=1, stable=True).indices
    rows = torch.gather(flat, 1, order.unsqueeze(-1).expand(-1, -1, k))
    boxes = rows[:, :, cs:cs + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    valid = rows[:, :, si] > valid_thresh
    if topk > 0:
        valid &= torch.arange(n, device=data.device) < topk
    ids = rows[:, :, ii].float().contiguous() \
        if ii >= 0 and not force_suppress else None
    return (rows, boxes.float().contiguous(), valid.sum(1, dtype=torch.int32),
            ids)


def _floats(v):
    return tuple(float(s) for s in (v if hasattr(v, "__len__") else (v,)))


@register("MultiBoxPrior",
          aliases=("multibox_prior", "_contrib_MultiBoxPrior"))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5), **_):
    """SSD anchors of a feature map ``data`` (B, C, H, W) -> (1, H*W*A, 4)
    corner boxes, A = len(sizes) + len(ratios) - 1 a position: every size
    at ``ratios[0]``, then every other ratio at ``sizes[0]``; centres at
    ``(i + offsets) * steps`` ((y, x); a step <= 0 is 1 / the map's
    size); ``clip`` clips them into [0, 1]."""
    h, w = data.shape[2], data.shape[3]
    sizes, ratios = _floats(sizes), _floats(ratios)
    steps, offsets = _floats(steps), _floats(offsets)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    f32 = dict(dtype=torch.float32, device=data.device)
    cy = (torch.arange(h, **f32) + offsets[0]) * step_y
    cx = (torch.arange(w, **f32) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cxg, cyg], dim=-1).reshape(-1, 2)
    shapes = [(s, ratios[0]) for s in sizes] \
        + [(sizes[0], r) for r in ratios[1:]]
    root = torch.sqrt(torch.tensor([r for _, r in shapes], **f32))
    size = torch.tensor([s for s, _ in shapes], **f32)
    wh = torch.stack([size * root, size / root], dim=-1)   # (A, 2)
    a = wh.shape[0]
    cxy = centers.repeat_interleave(a, dim=0)
    whs = wh.repeat(centers.shape[0], 1)
    anchors = torch.cat([cxy - whs / 2, cxy + whs / 2], dim=-1)
    if clip:
        anchors = anchors.clamp(0.0, 1.0)
    return anchors.unsqueeze(0).to(data.dtype)


def _softmax(x, dim):
    """``jax.nn.softmax``'s formula: exp(x - max) over its sum."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


@register("MultiBoxTarget",
          aliases=("multibox_target", "_contrib_MultiBoxTarget"),
          num_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2), **_):
    """SSD training targets.  ``anchor`` (1, N, 4) corners, ``label`` (B,
    M, 5) rows [class, x1, y1, x2, y2] (class -1: padding), ``cls_pred``
    (B, C+1, N) -> ``(loc_target (B, N*4), loc_mask (B, N*4), cls_target
    (B, N))``.

    Each valid ground-truth box claims its best anchor; an anchor is also
    positive at an IoU of at least ``overlap_threshold`` with its best
    box.  A positive anchor's target is its box's class + 1 and the
    offsets (centre over the anchor's size, log of the sizes' ratio, each
    over its ``variances``).  With ``negative_mining_ratio > 0`` the
    non-positive anchors whose best IoU is below
    ``negative_mining_thresh``, ranked by their background probability
    (softmax of ``cls_pred``, ascending, a stable sort), give ``ratio``
    times the positives (at least ``minimum_negative_samples``)
    background targets (0); every other anchor gets ``ignore_label``.
    Without mining every non-positive anchor is background."""
    with torch.no_grad():
        return _multibox_target(
            anchor, label, cls_pred, float(overlap_threshold),
            float(ignore_label), float(negative_mining_ratio),
            float(negative_mining_thresh), int(minimum_negative_samples),
            _floats(variances))


def _multibox_target(anchor, label, cls_pred, overlap_threshold,
                     ignore_label, ratio, mining_thresh, min_neg, variances):
    anchors = anchor[0]
    n = anchors.shape[0]
    b = label.shape[0]
    cols = torch.arange(n, device=anchor.device)
    gt_valid = label[:, :, 0] >= 0                                 # (B, M)
    gt_boxes = label[:, :, 1:5]
    ious = corner_iou(anchors.expand(b, n, 4), gt_boxes)           # (B, N, M)
    ious = torch.where(gt_valid.unsqueeze(1), ious,
                       torch.full_like(ious, -1.0))
    best_iou, best_gt = ious.max(dim=2)
    # bipartite stage: each valid box claims its best anchor, through an
    # (M, N) claim matrix as the JAX package does
    best_anchor = ious.argmax(dim=1)                               # (B, M)
    claim = (best_anchor.unsqueeze(2) == cols) & gt_valid.unsqueeze(2)
    claimed = claim.any(dim=1)
    claimed_gt = claim.to(torch.int32).argmax(dim=1)
    pos = claimed | (best_iou >= overlap_threshold)
    match = torch.where(claimed, claimed_gt, best_gt)
    matched = torch.gather(gt_boxes, 1, match.unsqueeze(-1).expand(-1, -1, 4))
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = (anchors[:, 2] - anchors[:, 0]).clamp(min=1e-8)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp(min=1e-8)
    gcx = (matched[..., 0] + matched[..., 2]) / 2
    gcy = (matched[..., 1] + matched[..., 3]) / 2
    gw = (matched[..., 2] - matched[..., 0]).clamp(min=1e-8)
    gh = (matched[..., 3] - matched[..., 1]).clamp(min=1e-8)
    loc_t = torch.stack([(gcx - acx) / aw / variances[0],
                         (gcy - acy) / ah / variances[1],
                         torch.log(gw / aw) / variances[2],
                         torch.log(gh / ah) / variances[3]], dim=-1)
    loc_t = torch.where(pos.unsqueeze(-1), loc_t,
                        torch.zeros_like(loc_t)).reshape(b, n * 4)
    loc_m = pos.to(torch.float32).repeat_interleave(4, dim=1)
    cls = torch.gather(label[:, :, 0], 1, match) + 1.0
    if ratio > 0:
        bg_prob = _softmax(cls_pred.float(), 1)[:, 0]              # (B, N)
        cand = ~pos & (best_iou < mining_thresh)
        num_pos = pos.sum(dim=1)
        num_neg = (num_pos.to(torch.float32) * ratio).to(torch.int32) \
            .clamp(min=min_neg)
        num_neg = torch.minimum(num_neg, (n - num_pos).to(torch.int32))
        key = torch.where(cand, bg_prob, torch.full_like(bg_prob, math.inf))
        order = torch.sort(key, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, cols.expand(b, n).contiguous())
        neg = cand & (rank < num_neg.unsqueeze(1))
        cls_t = torch.where(pos, cls, torch.where(
            neg, torch.zeros_like(cls), torch.full_like(cls, ignore_label)))
    else:
        cls_t = torch.where(pos, cls, torch.zeros_like(cls))
    dt = anchor.dtype
    return loc_t.to(dt), loc_m.to(dt), cls_t.to(dt)


@register("MultiBoxDetection",
          aliases=("multibox_detection", "_contrib_MultiBoxDetection"))
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1, **_):
    """SSD detections: ``cls_prob`` (B, C+1, N), ``loc_pred`` (B, N*4) and
    ``anchor`` (1, N, 4) -> (B, N, 6) rows [class, score, x1, y1, x2, y2].
    The offsets are decoded against the anchors (``clip``: into [0, 1]),
    each anchor takes its best foreground class (its index among the
    classes other than ``background_id``) with a score above
    ``threshold`` (else class and score -1), then :func:`box_nms` by class
    (every class with ``force_suppress``) at ``nms_threshold`` over the
    first ``nms_topk``; a suppressed row's class is -1."""
    b = cls_prob.shape[0]
    n = anchor.shape[1]
    v = _floats(variances)
    anchors = anchor[0]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    loc = loc_pred.reshape(b, n, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw
    h = torch.exp(loc[..., 3] * v[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    bg = int(background_id)
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
    score, cls_id = fg.max(dim=1)
    keep = score > threshold
    minus = torch.full_like(score, -1.0)
    cls_id = torch.where(keep, cls_id.to(cls_prob.dtype), minus)
    score = torch.where(keep, score, minus)
    rows = torch.cat([cls_id.unsqueeze(-1), score.unsqueeze(-1), boxes],
                     dim=-1)
    out = box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                  topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                  force_suppress=force_suppress)
    sup = out[..., 1] <= 0
    return torch.cat([torch.where(sup, torch.full_like(out[..., 0], -1.0),
                                  out[..., 0]).unsqueeze(-1), out[..., 1:]],
                     dim=-1)
