"""The port's detection ops (ops/contrib.py) and its NMS kernel's plain
version (ops/box_nms.py, K7) against the JAX package's ops, on the CPU,
where the wrapper takes the plain version.

Tolerances: class ids, masks, keep sets and the order of the rows equal;
coordinates, offsets and scores within 1e-6 (relative, and absolute
scaled by the largest magnitude when it exceeds 1): the same float32
operations in the same order, XLA and PyTorch each rounding them once
(the offsets' divisions by a variance may round once more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mxnet_tpu.ops import contrib as jc
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import box_nms as tbn
from mxnet_tpu_torch.ops import contrib as tc

TOL = 1e-6


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


def _boxes(rs, shape, lo=0.0, hi=0.7, size=(0.05, 0.3)):
    xy = rs.uniform(lo, hi, shape + (2,))
    wh = rs.uniform(size[0], size[1], shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _nms_rows(seed, b=3, n=40, classes=3, centres=4):
    """Rows [id, score, x1, y1, x2, y2] clustered around a few centres, so
    that many overlap; some scores tie, some are negative."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(0.3, 0.7, (centres, 2))[rs.randint(0, centres, (b, n))]
    half = rs.uniform(0.05, 0.2, (b, n, 2))
    score = rs.choice([0.9, 0.5, 0.3, 0.05, -0.2], (b, n, 1)) \
        + rs.uniform(0, 0.02, (b, n, 1)) * rs.randint(0, 2, (b, n, 1))
    return np.concatenate([rs.randint(0, classes, (b, n, 1)), score,
                           c - half, c + half], -1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    rs = np.random.RandomState(1)
    a, b = _boxes(rs, (2, 7)), _boxes(rs, (2, 5))
    a[0, 0] = [0.5, 0.5, 0.4, 0.6]  # an empty box: union of b alone
    if fmt == "center":
        a = np.concatenate([(a[..., :2] + a[..., 2:]) / 2,
                            a[..., 2:] - a[..., :2]], -1)
        b = np.concatenate([(b[..., :2] + b[..., 2:]) / 2,
                            b[..., 2:] - b[..., :2]], -1)
    want = jc.box_iou(jnp.asarray(a), jnp.asarray(b), format=fmt)
    got = tc.box_iou(torch.from_numpy(a), torch.from_numpy(b), format=fmt)
    assert got.shape == (2, 7, 5)
    _close(got.numpy(), want)


NMS_FLAGS = {
    "defaults": {},
    "by-class": {"id_index": 0, "overlap_thresh": 0.4},
    "topk": {"id_index": 0, "topk": 11, "overlap_thresh": 0.3},
    "force-suppress": {"id_index": 0, "force_suppress": True,
                       "overlap_thresh": 0.45},
    "id-index-minus-1": {"id_index": -1, "overlap_thresh": 0.3},
    "valid-thresh": {"id_index": 0, "valid_thresh": 0.4},
    "center": {"id_index": 0, "in_format": "center", "overlap_thresh": 0.3},
    "score-column-0": {"score_index": 0, "coord_start": 2, "id_index": 1},
}


@pytest.mark.parametrize("case", sorted(NMS_FLAGS))
def test_box_nms_matches_jax(case):
    rows = _nms_rows(len(case))
    if case == "center":
        rows[..., 2:4], rows[..., 4:6] = (rows[..., 2:4] + rows[..., 4:6]) \
            / 2, rows[..., 4:6] - rows[..., 2:4]
    if case == "score-column-0":
        rows = rows[..., [1, 0, 2, 3, 4, 5]]
    kw = NMS_FLAGS[case]
    want = np.asarray(jc.box_nms(jnp.asarray(rows), **kw))
    got = tc.box_nms(torch.from_numpy(rows), **kw).numpy()
    si = kw.get("score_index", 1)
    kept = want[..., si] != -1
    assert kept.any() and (~kept).any()  # the case suppresses something
    np.testing.assert_array_equal(got[..., si] == -1, ~kept)
    # the row order (by every column but the score) and the scores
    np.testing.assert_array_equal(np.delete(got, si, -1),
                                  np.delete(want, si, -1))
    _close(got, want)


def test_box_nms_ties_keep_the_jax_order():
    """Many rows of one score (-1 and 0.5): the stable sort keeps their
    order, as jnp.argsort does."""
    rows = _nms_rows(7, b=2, n=30)
    rows[:, ::2, 1] = -1.0
    rows[:, 1::4, 1] = 0.5
    want = np.asarray(jc.box_nms(jnp.asarray(rows), id_index=0))
    got = tc.box_nms(torch.from_numpy(rows), id_index=0).numpy()
    np.testing.assert_array_equal(got, want)


def test_box_nms_batch_axes_and_nd_contrib():
    rows = _nms_rows(9, b=6, n=10).reshape(2, 3, 10, 6)
    want = np.asarray(jc.box_nms(jnp.asarray(rows), overlap_thresh=0.3))
    got = tmx.nd.contrib.box_nms(tmx.nd.array(rows, ctx=tmx.cpu()),
                                 overlap_thresh=0.3)
    assert got.shape == (2, 3, 10, 6)
    _close(got.asnumpy(), want)
    for name in ("box_iou", "box_nms", "MultiBoxPrior", "MultiBoxTarget",
                 "MultiBoxDetection"):
        assert getattr(tmx.nd.contrib, name) is not None


def _jax_keep(boxes, n_valid, thresh, ids=None):
    """The JAX package's loop (contrib.py:92-104), one image at a time."""
    out = []
    for b in range(boxes.shape[0]):
        n = boxes.shape[1]
        bx = jnp.asarray(boxes[b])
        ious = jc._corner_iou(bx, bx)
        valid = jnp.arange(n) < int(n_valid[b])
        same = jnp.ones((n, n), bool) if ids is None else \
            jnp.asarray(ids[b])[:, None] == jnp.asarray(ids[b])[None, :]

        def body(i, keep, ious=ious, valid=valid, same=same, n=n):
            sup = keep[i] & valid[i]
            over = (ious[i] > thresh) & same[i] & (jnp.arange(n) > i)
            return jnp.where(sup & over, False, keep)

        keep = lax.fori_loop(0, n, body, jnp.ones((n,), bool))
        out.append(np.asarray(keep & valid))
    return np.stack(out)


@pytest.mark.parametrize("with_ids", [False, True])
def test_plain_keep_matches_the_jax_loop(with_ids):
    rows = _nms_rows(3, b=4, n=50)
    boxes = np.ascontiguousarray(rows[..., 2:6])
    ids = np.ascontiguousarray(rows[..., 0]) if with_ids else None
    n_valid = np.array([50, 31, 0, 7], dtype=np.int32)
    want = _jax_keep(boxes, n_valid, 0.35, ids)
    got = tbn.nms_keep_plain(torch.from_numpy(boxes),
                             torch.from_numpy(n_valid), 0.35,
                             None if ids is None else torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2].any() and got[3, 7:].sum() == 0


def test_plain_keep_at_iou_just_above_and_below_the_threshold():
    """Pairs whose IoU lies one float32 step above, at, and below the
    threshold: suppressed only when above, in both packages."""
    base = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    boxes = []
    for dx in (0.25, 0.3, 1.0 / 3.0):
        other = base + np.float32([dx, 0, dx, 0])
        boxes += [base, other]
    boxes = np.stack(boxes).astype(np.float32)[None]
    ious = np.asarray(jc._corner_iou(jnp.asarray(boxes[0]),
                                     jnp.asarray(boxes[0])))
    pairs = [ious[i, i + 1] for i in (0, 2, 4)]
    n_valid = np.array([6], np.int32)
    for k in range(3):
        for thresh in (np.nextafter(pairs[k], np.float32(0)), pairs[k],
                       np.nextafter(pairs[k], np.float32(1))):
            b = np.ascontiguousarray(boxes[:, 2 * k:2 * k + 2])
            want = _jax_keep(b, np.array([2], np.int32), float(thresh))
            got = tbn.nms_keep(torch.from_numpy(b),
                               torch.tensor([2], dtype=torch.int32),
                               float(thresh))
            np.testing.assert_array_equal(got.numpy(), want)
            assert bool(got[0, 1]) == (not pairs[k] > thresh)
    assert tbn.nms_keep_plain(torch.from_numpy(boxes),
                              torch.from_numpy(n_valid), 0.5).shape == (1, 6)


def test_keep_wrapper_on_the_cpu_counts_no_launch_and_plans():
    rows = _nms_rows(5)
    boxes = torch.from_numpy(np.ascontiguousarray(rows[..., 2:6]))
    n_valid = torch.tensor([40, 12, 3], dtype=torch.int32)
    before = tbn.nms_keep.launches
    np.testing.assert_array_equal(
        tbn.nms_keep(boxes, n_valid, 0.5).numpy(),
        tbn.nms_keep_plain(boxes, n_valid, 0.5).numpy())
    assert tbn.nms_keep.launches == before
    plan = tbn.launch_plan(32, 8732)
    assert plan.limit == 8732 and plan.route == "class-aware"
    # no mask (the mask design's: 32 * 8732 * 137 words, 306 MB): the boxes,
    # areas and rows in sorted order and the segment lists, under 9 MB
    assert plan.scratch_bytes == 32 * 8732 * 24 + 2 * 32 * 4367 * 8 + 256
    assert plan.grid == (4, 32)
    assert plan.walk_smem == (2 * 64 + 2 + 138) * 8 + 8732 * 20
    small = tbn.launch_plan(32, 8732, topk=400)
    assert small.limit == 400
    assert small.walk_smem == (2 * 64 + 2 + 8) * 8 + 400 * 20
    assert small.scratch_bytes == 32 * 400 * 24 + 2 * 32 * 201 * 8 + 256
    for bad in ((boxes.double(), n_valid), (boxes, n_valid.long()),
                (boxes[:, :, :3], n_valid), (boxes, n_valid[:2])):
        with pytest.raises(MXNetError, match="nms_keep"):
            tbn.nms_keep(*bad, 0.5)


PRIOR_CASES = {
    "defaults": ((1, 3, 4, 6), {}),
    "sizes-ratios": ((2, 3, 5, 5), {"sizes": (0.2, 0.35, 0.5),
                                    "ratios": (1.0, 2.0, 0.5, 3.0)}),
    "steps": ((1, 1, 6, 4), {"sizes": (0.3,), "ratios": (1.0, 2.0),
                             "steps": (0.125, 0.25)}),
    "offsets": ((1, 1, 3, 3), {"sizes": (0.6, 0.8), "offsets": (0.2, 0.7)}),
    "clip": ((1, 1, 3, 3), {"sizes": (0.6, 0.9), "ratios": (1.0, 3.0),
                            "clip": True}),
    "ssd300-first-map": ((1, 2, 38, 38), {"sizes": (.1, .141),
                                          "ratios": (1, 2, .5),
                                          "steps": (8 / 300, 8 / 300)}),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_multibox_prior_matches_jax(case):
    shape, kw = PRIOR_CASES[case]
    x = np.zeros(shape, np.float32)
    want = np.asarray(jc.multibox_prior(jnp.asarray(x), **kw))
    got = tc.multibox_prior(torch.from_numpy(x), **kw)
    assert got.shape == want.shape and not got.requires_grad
    _close(got.numpy(), want)


def _target_inputs(seed, b=3, n=60, m=4, classes=5):
    rs = np.random.RandomState(seed)
    anchors = _boxes(rs, (n,), size=(0.1, 0.35))[None]
    label = np.concatenate([rs.randint(0, classes, (b, m, 1)),
                            _boxes(rs, (b, m), size=(0.15, 0.3))], -1)
    label[0, 2:] = -1               # padding rows
    label[1, :] = -1                # an image with no box
    cls_pred = rs.randn(b, classes + 1, n)
    return [a.astype(np.float32) for a in (anchors, label, cls_pred)]


TARGET_CASES = {
    "no-mining": {},
    "mining": {"negative_mining_ratio": 3.0},
    "mining-min-negatives": {"negative_mining_ratio": 1.0,
                             "minimum_negative_samples": 9,
                             "negative_mining_thresh": 0.3},
    "threshold-variances": {"overlap_threshold": 0.3,
                            "variances": (0.2, 0.2, 0.1, 0.1),
                            "ignore_label": -2.0,
                            "negative_mining_ratio": 2.0},
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_multibox_target_matches_jax(case):
    anchors, label, cls_pred = _target_inputs(len(case))
    kw = TARGET_CASES[case]
    want = [np.asarray(o) for o in jc.multibox_target(
        jnp.asarray(anchors), jnp.asarray(label), jnp.asarray(cls_pred),
        **kw)]
    got = [o.numpy() for o in tc.multibox_target(
        torch.from_numpy(anchors), torch.from_numpy(label),
        torch.from_numpy(cls_pred), **kw)]
    np.testing.assert_array_equal(got[1], want[1])       # the mask
    np.testing.assert_array_equal(got[2], want[2])       # the classes
    _close(got[0], want[0])
    assert (want[2][1] <= 0).all()  # the image with no box: no positive
    if kw.get("negative_mining_ratio", -1.0) > 0:
        assert (want[2] == kw.get("ignore_label", -1.0)).any()


def test_multibox_target_claims_an_anchor_below_the_threshold():
    """A box whose best anchor overlaps it below the threshold still claims
    that anchor (the bipartite stage), as in the JAX package."""
    anchors = np.float32([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.9, 0.9],
                           [0.6, 0.0, 1.0, 0.3]]])
    label = np.float32([[[3, 0.0, 0.0, 0.5, 0.5], [-1, -1, -1, -1, -1]]])
    cls_pred = np.zeros((1, 5, 3), np.float32)
    want = [np.asarray(o) for o in jc.multibox_target(
        jnp.asarray(anchors), jnp.asarray(label), jnp.asarray(cls_pred))]
    got = [o.numpy() for o in tc.multibox_target(
        torch.from_numpy(anchors), torch.from_numpy(label),
        torch.from_numpy(cls_pred))]
    np.testing.assert_array_equal(got[2], [[4.0, 0.0, 0.0]])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[0], want[0])


def test_multibox_target_carries_no_gradient():
    anchors, label, cls_pred = (torch.from_numpy(a)
                                for a in _target_inputs(2))
    cls_pred.requires_grad_()
    outs = tc.multibox_target(anchors, label, cls_pred,
                              negative_mining_ratio=3.0)
    assert not any(o.requires_grad for o in outs)


DETECTION_CASES = {
    "defaults": {},
    "nms-0.45": {"nms_threshold": 0.45, "threshold": 0.15},
    "no-clip": {"clip": False, "threshold": 0.1},
    "force-suppress": {"force_suppress": True, "threshold": 0.1},
    "topk": {"nms_topk": 20, "nms_threshold": 0.3},
    "background-2": {"background_id": 2, "threshold": 0.1,
                     "variances": (0.2, 0.2, 0.3, 0.3)},
}


@pytest.mark.parametrize("case", sorted(DETECTION_CASES))
def test_multibox_detection_matches_jax(case):
    rs = np.random.RandomState(len(case) + 40)
    anchors = _boxes(rs, (80,), lo=0.2, hi=0.5, size=(0.1, 0.4))[None]
    logits = rs.randn(2, 4, 80).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(2, 320) * 0.5).astype(np.float32)
    kw = DETECTION_CASES[case]
    want = np.asarray(jc.multibox_detection(
        jnp.asarray(prob), jnp.asarray(loc), jnp.asarray(anchors), **kw))
    got = tc.multibox_detection(torch.from_numpy(prob),
                                torch.from_numpy(loc),
                                torch.from_numpy(anchors), **kw).numpy()
    assert got.shape == (2, 80, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (want[..., 0] >= 0).any() and (want[..., 0] < 0).any()
    _close(got, want)
