"""Greedy non-maximum suppression of the PyTorch port (K7).

Not the counterpart of a Pallas kernel: the JAX package runs ``box_nms``
(``mxnet_tpu/ops/contrib.py:62-107``) as a ``lax.fori_loop`` over all N
sorted rows, one device loop once XLA compiles it.  Written in plain
PyTorch that loop is N sequential steps of several launches each, so on
the card it is the port's own kernel, ``csrc/box_nms.cu``: a pass that
writes, for each valid row, a bit mask of the later rows it suppresses,
then one block an image that walks the rows in order.

The rows come sorted by score, descending (``box_nms`` in
:mod:`.contrib` sorts them, stably, as ``jnp.argsort`` does), and the
first ``n_valid[b]`` of image ``b`` are valid: score above the threshold
and rank below ``topk``, a prefix of the sorted order.  The keep set is
the JAX loop's exactly: a valid row still kept removes the later rows
whose IoU with it (:func:`corner_iou`, float32, ``_corner_iou``'s
operations in its order) is above ``overlap_thresh`` and, where ``ids``
is given, whose class id equals its own; only valid rows are kept.

- :func:`nms_keep_plain` is the plain version, the JAX loop over the
  valid rows with one IoU row a step;
- :func:`nms_keep` launches K7 on CUDA tensors, with no fallback, and
  takes the plain version on CPU tensors; it counts its launches in
  ``.launches``;
- :func:`launch_plan` says from the shapes what a launch runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _kernels
from ..base import MXNetError

__all__ = ["corner_iou", "nms_keep", "nms_keep_plain", "launch_plan",
           "LaunchPlan"]

TILE = 64           # rows and columns of a mask block; bits of a word
WALK_THREADS = 256  # threads of the walking block
_MAX_SMEM = 48 * 1024


class LaunchPlan(NamedTuple):
    """A K7 launch: ``limit`` rows and columns of each image can be kept
    (``topk`` where it is given, else N), the mask's ``words`` a row and
    its bytes, pass 1's grid (column tiles, row tiles, images) of
    ``TILE`` threads, pass 2's ``images`` blocks of ``WALK_THREADS``
    threads with ``walk_smem`` bytes of removed bits."""
    limit: int
    words: int
    mask_bytes: int
    mask_grid: tuple
    walk_smem: int


def launch_plan(b, n, topk=-1):
    """The :class:`LaunchPlan` of ``b`` images of ``n`` sorted rows, of
    which at most ``topk`` (all where ``topk <= 0``) are valid."""
    limit = min(n, topk) if topk > 0 else n
    words = -(-limit // TILE)
    return LaunchPlan(limit, words, b * limit * words * 8,
                      (words, words, b), words * 8)


def corner_iou(a, b):
    """IoU of corner boxes, ``a`` (..., M, 4) against ``b`` (..., N, 4) ->
    (..., M, N), 0 where the union is not positive: the JAX package's
    ``_corner_iou`` (``contrib.py:26-41``), operation for operation."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = (v.unsqueeze(-2) for v in b.unbind(-1))
    ax1, ay1, ax2, ay2 = (v.unsqueeze(-1) for v in (ax1, ay1, ax2, ay2))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _check(boxes, n_valid, ids):
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or boxes.dtype != torch.float32:
        raise MXNetError("nms_keep takes float32 boxes (B, N, 4), got %s %s"
                         % (tuple(boxes.shape), boxes.dtype))
    b, n = boxes.shape[:2]
    if n_valid.shape != (b,) or n_valid.dtype != torch.int32:
        raise MXNetError("nms_keep takes n_valid int32 (B,), got %s %s"
                         % (tuple(n_valid.shape), n_valid.dtype))
    if ids is not None and (ids.shape != (b, n)
                            or ids.dtype != torch.float32):
        raise MXNetError("nms_keep takes float32 ids (B, N), got %s %s"
                         % (tuple(ids.shape), ids.dtype))
    tensors = [boxes, n_valid] + ([] if ids is None else [ids])
    if any(t.device != boxes.device for t in tensors):
        raise MXNetError("nms_keep's tensors lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("nms_keep takes contiguous tensors")
    if boxes.device.type not in ("cpu", "cuda"):
        raise MXNetError("nms_keep runs on CPU or CUDA tensors, not %s"
                         % boxes.device)


def nms_keep_plain(boxes, n_valid, overlap_thresh, ids=None):
    """Plain keep set (B, N) bool: the JAX loop, batched over the images,
    over the rows that can suppress (the valid ones)."""
    _check(boxes, n_valid, ids)
    b, n = boxes.shape[:2]
    cols = torch.arange(n, device=boxes.device)
    keep = cols < n_valid.unsqueeze(1)
    for i in range(int(n_valid.max()) if b else 0):
        over = (corner_iou(boxes[:, i:i + 1], boxes)[:, 0]
                > overlap_thresh) & (cols > i)
        if ids is not None:
            over &= ids == ids[:, i:i + 1]
        keep &= ~(keep[:, i:i + 1] & over)
    return keep


def nms_keep(boxes, n_valid, overlap_thresh, ids=None, topk=-1):
    """Greedy NMS keep set (B, N) bool of ``boxes`` (B, N, 4) float32,
    corner rows sorted by score, descending, the first ``n_valid`` (B,)
    int32 of each image valid (at most ``topk`` of them where ``topk >
    0``); ``ids`` (B, N) float32 restricts suppression to one class, None
    lets every row suppress every other.  K7 on CUDA tensors, the plain
    version on CPU tensors."""
    _check(boxes, n_valid, ids)
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, n_valid, overlap_thresh, ids)
    b, n = boxes.shape[:2]
    plan = launch_plan(b, n, topk)
    if plan.walk_smem > _MAX_SMEM:
        raise MXNetError("nms_keep takes at most %d rows an image on the "
                         "card, got %d" % (_MAX_SMEM // 8 * TILE, plan.limit))
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    lib = _kernels.library("box_nms")
    mask = torch.empty(plan.mask_bytes // 8, dtype=torch.int64,
                       device=boxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    _kernels.launch(lib, lib.mxt_box_nms, boxes, ids, n_valid, mask, keep, b,
                    n, plan.limit, float(overlap_thresh))
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
