"""K7's design (csrc/box_nms.cu) as a plain model, on the CPU, against
the plain keep set (ops/box_nms.py nms_keep_plain) and the JAX package's
box_nms; and K7's launch plan.

The model follows the kernel's arithmetic and order: each valid row's
class key as the scan kernel makes it (the id, -0.0 made 0.0; a NaN id in
no class), one stable sort of each image's keys, a segment for each run
of equal keys (a row of no class or a run of one row is settled alone),
and each segment walked 64 rows at a time: a tile's live rows resolved
in order by the kernel's pair test, then the tile's kept rows tested
against the later live rows; the keep flags scattered back to the
score-sorted positions.  Its pair test is the kernel's: each box's area
once, fmax/fmin for the intersection, the division only where the
intersection and the union are positive.

Tolerances: none.  Keep sets are compared bit for bit, box_nms's rows
exactly (NaN ids in equal places).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import contrib as jc
from mxnet_tpu_torch.ops import box_nms as tbn
from mxnet_tpu_torch.ops import contrib as tc

TILE = tbn.TILE


def _align16(v):
    return -(-v // 16) * 16


def _area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0) \
        * (b[..., 3] - b[..., 1]).clamp(min=0)


def _over(a, c, thresh):
    """The kernel's pair test: corner_iou(a, c) > thresh for one earlier
    row a (4,) against later rows c (M, 4)."""
    iw = torch.fmax(torch.fmin(a[2], c[:, 2]) - torch.fmax(a[0], c[:, 0]),
                    torch.zeros(()))
    ih = torch.fmax(torch.fmin(a[3], c[:, 3]) - torch.fmax(a[1], c[:, 1]),
                    torch.zeros(()))
    inter = iw * ih
    uni = (_area(a) + _area(c)) - inter
    iou = torch.where((inter > 0) & (uni > 0), inter / uni,
                      torch.zeros_like(inter))
    return iou > thresh


def _segment_walk(box, thresh):
    """A segment's keep flags, 64 rows at a time as the kernel walks it."""
    n = box.shape[0]
    removed = torch.zeros(n, dtype=torch.bool)
    keep = torch.zeros(n, dtype=torch.bool)
    for lo in range(0, n, TILE):
        hi = min(n, lo + TILE)
        alive = ~removed[lo:hi]
        kept = []
        for r in range(hi - lo):  # the tile, resolved in order
            if alive[r]:
                kept.append(lo + r)
                alive[r + 1:] &= ~_over(box[lo + r], box[lo + r + 1:hi],
                                        thresh)
        keep[kept] = True
        for k in kept:  # the tile's kept rows against the later live rows
            removed[hi:] |= ~removed[hi:] & _over(box[k], box[hi:], thresh)
    return keep


def class_keys(ids, n_valid, n, limit):
    """The scan kernel's class keys (B, N), as floats, NaN for a row of no
    class or not valid; ids None: one class."""
    b = n_valid.shape[0]
    valid = torch.arange(n) < n_valid.clamp(0, limit).unsqueeze(1)
    if ids is None:
        ids = torch.zeros((b, n))
    key = torch.where(ids == 0, torch.zeros_like(ids), ids)
    return torch.where(valid & (ids == ids), key,
                       torch.full_like(ids, float("nan")))


def nms_keep_model(boxes, n_valid, thresh, ids=None, topk=-1):
    """K7's keep set, by the class-partitioned walk."""
    b, n = boxes.shape[:2]
    limit = min(n, topk) if topk > 0 else n
    nv = n_valid.clamp(0, limit)
    keys = class_keys(ids, n_valid, n, limit)
    sk, order = torch.sort(keys, dim=1, stable=True)
    keep = torch.zeros((b, n), dtype=torch.bool)
    for img in range(b):
        p = 0
        while p < n:
            k = float(sk[img, p])
            if math.isnan(k):  # a row of no segment
                i = int(order[img, p])
                keep[img, i] = i < int(nv[img])
                p += 1
                continue
            q = p
            while q + 1 < n and float(sk[img, q + 1]) == k:
                q += 1
            rows = order[img, p:q + 1]
            keep[img, rows] = _segment_walk(boxes[img, rows], thresh)
            p = q + 1
    return keep


def _rows(seed, b=3, n=120, classes=3, centres=4):
    """Rows [id, score, x1, y1, x2, y2] clustered around a few centres; some
    scores tie, some are negative."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(0.3, 0.7, (centres, 2))[rs.randint(0, centres, (b, n))]
    half = rs.uniform(0.05, 0.2, (b, n, 2))
    score = rs.choice([0.9, 0.5, 0.3, 0.05, -0.2], (b, n, 1)) \
        + rs.uniform(0, 0.02, (b, n, 1)) * rs.randint(0, 2, (b, n, 1))
    return np.concatenate([rs.randint(0, classes, (b, n, 1)), score,
                           c - half, c + half], -1).astype(np.float32)


def _nan_ids(rows, rs):
    rows[..., 0][rs.uniform(size=rows.shape[:2]) < 0.15] = np.nan


def _signed_zeros(rows, rs):
    zero = rows[..., 0] == 0
    rows[..., 0][zero & (rs.uniform(size=rows.shape[:2]) < 0.5)] = -0.0


def _ties(rows, rs):
    rows[..., 1] = 0.5


def _one_class(rows, rs):
    rows[..., 0] = 7.0


def _one_row_a_class(rows, rs):
    rows[..., 0] = np.arange(rows.shape[1])


def _degenerate(rows, rs):
    pick = rs.uniform(size=rows.shape[:2] + (4,)) < 0.05
    rows[..., 2:][pick] = rs.choice([np.nan, np.inf, -np.inf, 0.0, -0.0],
                                    pick.sum())


# (rows' change, box_nms keywords)
MODEL_CASES = {
    "by-class": (None, {"id_index": 0, "overlap_thresh": 0.4}),
    "nan-ids": (_nan_ids, {"id_index": 0, "overlap_thresh": 0.3}),
    "signed-zero-ids": (_signed_zeros, {"id_index": 0,
                                        "overlap_thresh": 0.3}),
    "all-ties": (_ties, {"id_index": 0, "overlap_thresh": 0.35}),
    "all-one-class": (_one_class, {"id_index": 0, "overlap_thresh": 0.3}),
    "one-row-a-class": (_one_row_a_class, {"id_index": 0}),
    "topk": (None, {"id_index": 0, "topk": 11, "overlap_thresh": 0.3}),
    "force-suppress": (None, {"id_index": 0, "force_suppress": True,
                              "overlap_thresh": 0.45}),
    "id-index-minus-1": (None, {"id_index": -1, "overlap_thresh": 0.3}),
    "degenerate-boxes": (_degenerate, {"id_index": 0,
                                       "overlap_thresh": 0.3}),
    "negative-threshold": (None, {"id_index": 0, "overlap_thresh": -0.1}),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_partitioned_model_matches_plain_and_jax(case, monkeypatch):
    change, kw = MODEL_CASES[case]
    rs = np.random.RandomState(len(case))
    rows = _rows(len(case), n=150 if case == "all-one-class" else 120)
    if change is not None:
        change(rows, rs)
    data = torch.from_numpy(rows)
    _, boxes, n_valid, ids = tc.nms_inputs(
        data, kw.get("valid_thresh", 0.0), kw.get("topk", -1), 2, 1,
        kw["id_index"], kw.get("force_suppress", False))
    thresh = kw.get("overlap_thresh", 0.5)
    want = tbn.nms_keep_plain(boxes, n_valid, thresh, ids)
    got = nms_keep_model(boxes, n_valid, thresh, ids, kw.get("topk", -1))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # box_nms with the model as its keep set, against the JAX package's
    monkeypatch.setattr(tc, "nms_keep", lambda b, v, t, i=None, k=-1:
                        nms_keep_model(b, v, t, i, k))
    out = tc.box_nms(data, **kw).numpy()
    ref = np.asarray(jc.box_nms(jnp.asarray(rows), **kw))
    np.testing.assert_array_equal(out, ref)


def test_model_walks_a_segment_of_several_tiles():
    """One class of 300 valid rows: five tiles, kept rows of each tested
    against the later tiles."""
    rows = _rows(21, b=2, n=300, classes=1, centres=6)
    rows[..., 1] = np.abs(rows[..., 1]) + 0.01
    data = torch.from_numpy(rows)
    _, boxes, n_valid, ids = tc.nms_inputs(data, id_index=0)
    assert int(n_valid.min()) == 300
    want = tbn.nms_keep_plain(boxes, n_valid, 0.45, ids)
    got = nms_keep_model(boxes, n_valid, 0.45, ids)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert 1 < int(got.sum(1).min()) < 300


def test_class_keys_make_one_class_of_signed_zeros_and_none_of_nan():
    ids = torch.tensor([[0.0, -0.0, float("nan"), 2.0, -0.0, 5.0]])
    keys = class_keys(ids, torch.tensor([5], dtype=torch.int32), 6, 6)
    sk, order = torch.sort(keys, dim=1, stable=True)
    assert order.tolist() == [[0, 1, 4, 3, 2, 5]]
    assert sk[0, :4].tolist() == [0.0, 0.0, 0.0, 2.0]
    assert all(math.copysign(1, v) == 1 for v in sk[0, :3].tolist())
    assert torch.isnan(sk[0, 4:]).all()  # a NaN id; a row not valid


@pytest.mark.parametrize("thresh", [-0.5, 0.0, 0.3, 0.5, 1.0])
def test_pair_test_is_corner_iou_above_the_threshold(thresh):
    """The kernel's pair test against corner_iou on boxes with NaN, the
    infinities, signed zeros, empty and inverted boxes and pairs just
    touching."""
    rs = np.random.RandomState(3)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 0.5,
                        1e-30, 1e30], np.float32)
    boxes = rs.uniform(0, 1, (300, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2] * rs.choice([0.0, 1.0], (300, 2))
    pick = rs.uniform(size=boxes.shape) < 0.2
    boxes[pick] = rs.choice(special, pick.sum())
    boxes[:10] = [[0, 0, 1, 1], [1, 0, 2, 1], [0, 0, 0, 0], [0, 0, 1, 1],
                  [-0.0, -0.0, 1, 1], [2, 2, 1, 1], [0, 0, np.inf, 1],
                  [np.inf, 0, np.inf, 1], [0, 0, 1, np.nan], [0.5, 0, 1.5, 1]]
    b = torch.from_numpy(boxes)
    want = tbn.corner_iou(b, b) > thresh
    for i in range(b.shape[0]):
        got = _over(b[i], b, thresh)
        np.testing.assert_array_equal(got.numpy(), want[i].numpy())


def _check_regions(plan, b):
    """The scratch's regions as the C entry checks them: each 16-byte
    aligned, in order, with room for what it holds; the removed bits and
    the sort's buffers -1 (in shared memory) where the plan says so."""
    rows, cap = b * plan.limit, plan.limit // 2 + 1
    words = -(-plan.limit // TILE)
    need = (rows * 16, rows * 4, rows * 4, b * cap * 8, b * cap * 8, b * 8,
            b * plan.grid[0] * words * 8, rows * 16)
    assert len(plan.offsets) == len(tbn.REGIONS) == len(need)
    assert (plan.offsets[6] == -1) == plan.removed_in_smem
    assert (plan.offsets[7] == -1) == plan.sort_in_smem
    placed = [(o, r) for o, r in zip(plan.offsets, need) if o != -1]
    ends = [o for o, _ in placed[1:]] + [plan.scratch_bytes]
    for (at, size), end in zip(placed, ends):
        assert at % 16 == 0 and end - at == _align16(size)


def test_launch_plan_routes_grid_and_scratch():
    plan = tbn.launch_plan(32, 8732)
    assert plan.route == "class-aware" and plan.limit == 8732
    # the sort's digit counts and its buffers of 8,732 keys and rows
    assert plan.scan_smem == 256 * 33 * 4 + 8732 * 16 and plan.sort_in_smem
    assert plan.grid == (4, 32) and plan.threads == 1024
    # the removed bits (137 words) and the boxes and areas of 8,732 rows
    assert plan.walk_smem == tbn.WALK_SMEM_FIXED + 1104 + 8732 * 20
    assert plan.removed_in_smem and plan.boxes_in_smem
    cap = 8732 // 2 + 1
    assert plan.scratch_bytes == (32 * 8732 * 24 + 2 * 32 * cap * 8
                                  + 32 * 8)
    assert plan.scratch_bytes < 9 * 10 ** 6  # the mask design's: 306 MB
    rows = 32 * 8732
    assert plan.offsets == (0, rows * 16, rows * 20, rows * 24,
                            rows * 24 + 32 * cap * 8,
                            rows * 24 + 2 * 32 * cap * 8, -1, -1)
    _check_regions(plan, 32)
    single = tbn.launch_plan(32, 8732, classes=False)
    assert single.route == "single-class" and single.grid == (1, 32)
    assert single.scratch_bytes == plan.scratch_bytes
    assert single.walk_smem == plan.walk_smem
    assert single.scan_smem == plan.scan_smem
    assert single.offsets == plan.offsets
    small = tbn.launch_plan(32, 8732, topk=400)
    assert small.limit == 400
    assert small.walk_smem == tbn.WALK_SMEM_FIXED + 64 + 400 * 20
    assert tbn.launch_plan(32, 8732, sms=114).grid == (3, 32)
    assert tbn.launch_plan(1, 100).grid == (132, 1)
    assert tbn.launch_plan(200, 100).grid == (1, 200)


@pytest.mark.parametrize("n", [8732, 11498, 11499, 12416, 12417, 20000])
def test_launch_plan_keeps_a_long_segment_in_shared_memory_where_it_fits(n):
    plan = tbn.launch_plan(4, n)
    removed = tbn.WALK_SMEM_FIXED + _align16(-(-n // 64) * 8)
    assert plan.boxes_in_smem == (n <= 11498)
    assert plan.removed_in_smem
    assert plan.walk_smem == removed + (n * tbn.ROW_BYTES
                                        if plan.boxes_in_smem else 0)
    assert plan.sort_in_smem == (n <= 12416)
    assert plan.scan_smem == tbn.SCAN_SMEM_FIXED + (
        n * tbn.SORT_ROW_BYTES if plan.sort_in_smem else 0)
    assert max(plan.walk_smem, plan.scan_smem) <= tbn.MAX_SMEM
    rows, cap = 4 * n, n // 2 + 1
    assert plan.scratch_bytes == (
        _align16(rows * 16) + 2 * _align16(rows * 4)
        + 2 * _align16(4 * cap * 8) + 32
        + (0 if plan.sort_in_smem else _align16(rows * 16)))
    _check_regions(plan, 4)


@pytest.mark.parametrize("n", [393216, 400000, 1851264, 1851265, 2000000])
def test_launch_plan_past_the_old_row_limit(n):
    """The mask design refused more than 393,216 rows an image: its removed
    bits lay in 48 KB of static shared memory.  The removed bits of a
    long segment now lie in dynamic shared memory up to an H100 block's
    227 KB (1,851,264 rows), then in the scratch."""
    plan = tbn.launch_plan(2, n, classes=False)
    words = -(-n // 64)
    fits = n <= 1851264
    assert plan.removed_in_smem == fits and not plan.boxes_in_smem
    assert not plan.sort_in_smem and plan.scan_smem == tbn.SCAN_SMEM_FIXED
    assert plan.walk_smem == tbn.WALK_SMEM_FIXED + (_align16(words * 8)
                                                     if fits else 0)
    assert plan.walk_smem <= tbn.MAX_SMEM
    cap = n // 2 + 1
    assert plan.scratch_bytes == (
        _align16(2 * n * 16) + 2 * _align16(2 * n * 4)
        + 2 * _align16(2 * cap * 8) + 16 + _align16(2 * n * 16)
        + (0 if fits else _align16(2 * words * 8)))
    _check_regions(plan, 2)
    # by class: 66 walk blocks an image, each with removed bits of its own
    # where a long class's do not fit in shared memory
    by_class = tbn.launch_plan(2, n)
    assert by_class.grid == (66, 2)
    assert by_class.removed_in_smem == fits
    assert by_class.scratch_bytes == plan.scratch_bytes + (
        0 if fits else _align16(2 * 66 * words * 8) - _align16(2 * words * 8))
    _check_regions(by_class, 2)
