"""Greedy non-maximum suppression of the PyTorch port (K7).

Not the counterpart of a Pallas kernel: the JAX package runs ``box_nms``
(``mxnet_tpu/ops/contrib.py:62-107``) as a ``lax.fori_loop`` over all N
sorted rows, one device loop once XLA compiles it.  Written in plain
PyTorch that loop is N sequential steps of several launches each, so on
the card it is the port's own kernel, ``csrc/box_nms.cu``.  A row
suppresses only rows of its own class, so the kernel walks each class of
each image on its own: a scan kernel sorts each image's valid rows by
class (stably: a class's rows stay in score order) and lists the classes
("segments"), then a walk kernel resolves them over the whole card, 64
rows at a time, a warp a short segment and a block a long one.  On the
single-class route (``ids`` None) each image's valid rows are one
segment.

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

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _kernels
from ..base import MXNetError

__all__ = ["corner_iou", "nms_keep", "nms_keep_plain", "launch_plan",
           "LaunchPlan", "REGIONS"]

TILE = 64             # rows resolved together: the bits of a word
WALK_WARPS = 32       # warps of a walk block
# the scan's dynamic shared memory before the sort's buffers (the digit
# counts: 256 digits x 33 ints) and the bytes of a row in those buffers
# (two keys, two rows); the walk's before the removed bits (two tiles of
# suppression words, two kept masks) and the bytes of a long segment's
# row kept in it (a box and its area); a block's at most, on an H100.
# The C entry refuses shared memory below what its kernels' layouts take.
SCAN_SMEM_FIXED = 256 * 33 * 4
SORT_ROW_BYTES = 16
WALK_SMEM_FIXED = (2 * TILE + 2) * 8
ROW_BYTES = 20
MAX_SMEM = 232448
_SMS = 132            # streaming multiprocessors of an H100


class LaunchPlan(NamedTuple):
    """A K7 launch.  ``route`` "class-aware" (ids given: the scan sorts
    each image's valid rows by class) or "single-class"; ``limit`` rows of
    each image can be valid (``topk`` where it is given, else N); the
    scan's ``scan_smem`` bytes of dynamic shared memory, which hold the
    sort's buffers where ``sort_in_smem`` (else they lie in the scratch);
    the walk's ``grid`` (blocks an image, images) of ``threads`` threads
    with ``walk_smem`` bytes of dynamic shared memory, which hold a long
    segment's removed bits where ``removed_in_smem`` (a word a tile of
    ``limit`` rows; else they lie in the scratch) and its boxes and areas
    where ``boxes_in_smem``; ``scratch_bytes`` of scratch, its regions at
    the byte ``offsets`` of :data:`REGIONS` (-1 for a region that lies in
    shared memory).  The C entry takes these decisions as they are."""
    route: str
    limit: int
    scan_smem: int
    sort_in_smem: bool
    grid: tuple
    threads: int
    walk_smem: int
    removed_in_smem: bool
    boxes_in_smem: bool
    scratch_bytes: int
    offsets: tuple


# the scratch's regions, in order: the boxes, areas and rows in sorted
# order, the segments' first and last rows, their lists, their counts, the
# removed bits and the sort's buffers
REGIONS = ("box", "area", "order", "pairs", "lists", "counts", "removed",
           "sort")


def _align16(v):
    return -(-v // 16) * 16


def launch_plan(b, n, topk=-1, classes=True, sms=_SMS):
    """The :class:`LaunchPlan` of ``b`` images of ``n`` sorted rows, of
    which at most ``topk`` (all where ``topk <= 0``) are valid, by class
    (``classes``) or all one class, on a card of ``sms`` SMs: a pure
    function of its arguments.  The sort's buffers, a long segment's
    removed bits, then its boxes go to shared memory where they fit; the
    class-aware route deals each image ``sms // b`` walk blocks (at least
    one), so that the segments spread over the card, one block an SM when
    the boxes fill its shared memory; the single-class route has one
    segment an image, one block."""
    limit = min(n, topk) if topk > 0 else n
    words = -(-limit // TILE)
    sort = SCAN_SMEM_FIXED + limit * SORT_ROW_BYTES
    scan_smem = sort if sort <= MAX_SMEM else SCAN_SMEM_FIXED
    removed = WALK_SMEM_FIXED + _align16(words * 8)
    boxes = removed + limit * ROW_BYTES
    walk_smem = next(v for v in (boxes, removed, WALK_SMEM_FIXED)
                     if v <= MAX_SMEM)
    blocks = min(65535, max(1, sms // b)) if classes else 1
    rows, cap = b * limit, limit // 2 + 1  # cap: segments of two rows or more
    sizes = (rows * 16, rows * 4, rows * 4, b * cap * 8, b * cap * 8, b * 8,
             0 if walk_smem >= removed else b * blocks * words * 8,
             0 if scan_smem == sort else rows * 16)
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at if size else -1)
        at += _align16(size)
    return LaunchPlan("class-aware" if classes else "single-class", limit,
                      scan_smem, scan_smem == sort, (blocks, b),
                      WALK_WARPS * 32, walk_smem, walk_smem >= removed,
                      walk_smem == boxes, at, tuple(offsets))


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
    plan = launch_plan(b, n, topk, ids is not None,
                       _sm_count(boxes.device.index))
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=boxes.device)
    lib = _kernels.library("box_nms")
    _kernels.launch(lib, lib.mxt_box_nms, boxes, ids, n_valid, scratch, keep,
                    b, n, plan.limit, plan.grid[0], plan.scan_smem,
                    plan.walk_smem, int(plan.boxes_in_smem),
                    (ctypes.c_longlong * len(REGIONS))(*plan.offsets),
                    plan.scratch_bytes, float(overlap_thresh))
    nms_keep.launches += 1
    return keep


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


nms_keep.launches = 0
