"""Detection augmenters and ``ImageDetIter`` of the PyTorch port (the SSD
data path).

Counterpart of ``mxnet_tpu/image_detection.py`` (reference:
python/mxnet/image/detection.py: DetAugmenter, CreateDetAugmenter,
ImageDetIter).  A packed record's label is a flat float vector
``[header_width, obj_width, <header...>, obj0..., obj1..., ...]``
(``header_width`` >= 2, ``obj_width`` >= 5, each object ``[cls, xmin,
ymin, xmax, ymax, ...]`` with corners in [0, 1]): the records
``example/ssd`` packs, of any object count.  A batch's labels are padded
with -1 rows to the epoch's largest object count.

The geometry is host numpy, run in the iterator's thread or its
preprocess threads; the augmenters draw from the ``random`` module's
stream (and the classification augmenters from numpy's) in the JAX
package's order; each threaded sample draws from generators seeded by a
draw of the calling thread.  A batch crosses to the current context
once (through a ring of page-locked blocks on the card).
"""

from __future__ import annotations

import json
import logging
import random

import numpy as _np

from . import ndarray
from .io import io as _io
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug, HueJitterAug, ImageIter, LightingAug,
                    RandomGrayAug, ResizeAug, _SampleScopedStream, _like,
                    _to_host, fixed_crop)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


# Python-random twin of image.py's _nprand: det augmenters draw from
# the module-global `random` stream unless a preprocess worker installed
# a per-sample generator (see _SampleScopedStream).
_rand = _SampleScopedStream(random)


# ------------------------------------------------------ box geometry
# Object rows are [cls, x1, y1, x2, y2, ...]; helpers below take the
# (N, 4+) corner slice rows[:, 1:] so column 0..3 = x1, y1, x2, y2.

def _corner_areas(corners):
    """Areas of (N, 4+) normalized corner boxes; degenerate boxes -> 0."""
    w = _np.maximum(0.0, corners[:, 2] - corners[:, 0])
    h = _np.maximum(0.0, corners[:, 3] - corners[:, 1])
    return w * h


def _intersect_window(corners, x1, y1, x2, y2):
    """Clip each corner box to a window; fully-outside boxes -> all-zero."""
    out = corners.copy()
    out[:, 0] = _np.maximum(corners[:, 0], x1)
    out[:, 1] = _np.maximum(corners[:, 1], y1)
    out[:, 2] = _np.minimum(corners[:, 2], x2)
    out[:, 3] = _np.minimum(corners[:, 3], y2)
    dead = (out[:, 0] >= out[:, 2]) | (out[:, 1] >= out[:, 3])
    out[dead] = 0.0
    return out


# ------------------------------------------------------ augmenters


class DetAugmenter:
    """Base label-aware augmenter (reference: detection.py:39).

    __call__(src, label) -> (src, label): src is an HWC image — an
    NDArray, or on the iterator fast path a host array that still
    answers `.asnumpy()` — and label a (N, 5+) numpy array of
    [cls, x1, y1, x2, y2, ...] rows.
    """

    def __init__(self, **kwargs):
        self._kwargs = {
            k: (v.asnumpy().tolist() if isinstance(v, ndarray.NDArray)
                else v.tolist() if isinstance(v, _np.ndarray) else v)
            for k, v in kwargs.items()}

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift a label-invariant classification augmenter into the det
    pipeline (reference: detection.py DetBorrowAug)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("DetBorrowAug wraps classification Augmenters")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def dumps(self):
        return [self.__class__.__name__.lower(), self.augmenter.dumps()]

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply one randomly-chosen augmenter from a list, or skip all with
    probability skip_prob (reference: detection.py DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        if not isinstance(aug_list, (list, tuple)):
            aug_list = [aug_list]
        for aug in aug_list:
            if not isinstance(aug, DetAugmenter):
                raise ValueError("DetRandomSelectAug takes DetAugmenters")
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob if aug_list else 1

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [a.dumps() for a in self.aug_list]]

    def __call__(self, src, label):
        if _rand.random() < self.skip_prob:
            return src, label
        return _rand.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes with probability p (reference:
    detection.py DetHorizontalFlipAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _rand.random() < self.p:
            src = _like(_to_host(src)[:, ::-1].copy(), src)
            label = label.copy()
            x1, x2 = label[:, 1].copy(), label[:, 3].copy()
            label[:, 1] = 1.0 - x2
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Constrained random crop (reference: detection.py
    DetRandomCropAug): a proposal is accepted when EVERY object it
    overlaps keeps more than min_object_covered of its area (the
    reference's np.amin over positive coverages — overlap-a-sliver
    proposals are rejected rather than silently eating an object), and
    after the crop, objects keeping less than min_eject_coverage of
    their area are dropped from the label.

    Proposal sampling is re-designed: instead of the reference's
    height-first search we sample a target area uniformly in area_range
    and an aspect ratio in aspect_ratio_range, derive (w, h), and
    rejection-sample positions — the accepted crops satisfy the same
    constraint set.
    """

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.min_eject_coverage = min_eject_coverage
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = (0 < area_range[0] <= area_range[1]
                        and 0 < aspect_ratio_range[0] <= aspect_ratio_range[1])
        if not self.enabled:
            logging.warning("DetRandomCropAug disabled: invalid ranges %s %s",
                            area_range, aspect_ratio_range)

    def __call__(self, src, label):
        h, w = int(src.shape[0]), int(src.shape[1])
        found = self._propose(label, h, w)
        if found is not None:
            x0, y0, cw, ch, label = found
            src = fixed_crop(src, x0, y0, cw, ch, None)
        return src, label

    def _crop_satisfies(self, label, x1, y1, x2, y2, width, height):
        """The crop window (normalized corners) must cover >
        min_object_covered of at least one non-degenerate object."""
        corners = label[:, 1:]
        pixel_areas = _corner_areas(corners) * width * height
        live = pixel_areas > 2
        if not live.any():
            return False
        kept = _intersect_window(corners[live], x1, y1, x2, y2)
        cover = _corner_areas(kept) / (_corner_areas(corners[live]) + 1e-12)
        cover = cover[cover > 0]
        return cover.size > 0 and float(cover.min()) > self.min_object_covered

    def _relabel(self, label, x0, y0, cw, ch, height, width):
        """Express boxes in crop coordinates; drop ejected objects.
        Returns None when no object survives."""
        wx, wy = x0 / width, y0 / height
        sx, sy = cw / width, ch / height
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] - wx) / sx
        out[:, (2, 4)] = (out[:, (2, 4)] - wy) / sy
        out[:, 1:5] = _np.clip(out[:, 1:5], 0.0, 1.0)
        keep_frac = (_corner_areas(out[:, 1:]) * sx * sy
                     / (_corner_areas(label[:, 1:]) + 1e-12))
        alive = ((out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
                 & (keep_frac > self.min_eject_coverage))
        if not alive.any():
            return None
        return out[alive]

    def _propose(self, label, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return None
        full = float(height * width)
        for _ in range(self.max_attempts):
            area = _rand.uniform(*self.area_range) * full
            ratio = _rand.uniform(*self.aspect_ratio_range)
            cw = int(round((area * ratio) ** 0.5))
            ch = int(round((area / ratio) ** 0.5))
            if cw < 1 or ch < 1 or cw > width or ch > height or cw * ch < 2:
                continue
            x0 = _rand.randint(0, width - cw)
            y0 = _rand.randint(0, height - ch)
            if not self._crop_satisfies(label, x0 / width, y0 / height,
                                        (x0 + cw) / width, (y0 + ch) / height,
                                        width, height):
                continue
            new_label = self._relabel(label, x0, y0, cw, ch, height, width)
            if new_label is not None:
                return x0, y0, cw, ch, new_label
        return None


class DetRandomPadAug(DetAugmenter):
    """Random expansion: paste the image at a random offset on a larger
    canvas filled with pad_val; boxes shrink accordingly (reference:
    detection.py DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(128, 128, 128)):
        if not isinstance(pad_val, (list, tuple)):
            pad_val = (pad_val,)
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.pad_val = pad_val
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = (area_range[1] > 1.0
                        and area_range[0] <= area_range[1]
                        and 0 < aspect_ratio_range[0] <= aspect_ratio_range[1])
        if not self.enabled:
            logging.warning("DetRandomPadAug disabled: invalid ranges %s %s",
                            area_range, aspect_ratio_range)

    def __call__(self, src, label):
        h, w = int(src.shape[0]), int(src.shape[1])
        found = self._propose(label, h, w)
        if found is not None:
            x0, y0, cw, ch, label = found
            arr = _to_host(src)
            fill = _np.asarray(self.pad_val, dtype=arr.dtype)
            canvas = _np.empty((ch, cw, arr.shape[2]), dtype=arr.dtype)
            canvas[:] = fill
            canvas[y0:y0 + h, x0:x0 + w] = arr
            src = _like(canvas, src)
        return src, label

    def _relabel(self, label, x0, y0, cw, ch, height, width):
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] * width + x0) / cw
        out[:, (2, 4)] = (out[:, (2, 4)] * height + y0) / ch
        return out

    def _propose(self, label, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return None
        full = float(height * width)
        lo = max(1.0, self.area_range[0])
        for _ in range(self.max_attempts):
            area = _rand.uniform(lo, self.area_range[1]) * full
            ratio = _rand.uniform(*self.aspect_ratio_range)
            cw = int(round((area * ratio) ** 0.5))
            ch = int(round((area / ratio) ** 0.5))
            # the canvas must strictly contain the image, with enough
            # margin for the pad to matter
            if cw - width < 2 or ch - height < 2:
                continue
            x0 = _rand.randint(0, cw - width)
            y0 = _rand.randint(0, ch - height)
            return x0, y0, cw, ch, self._relabel(label, x0, y0, cw, ch,
                                                 height, width)
        return None


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """One DetRandomCropAug per parameter combination, wrapped in a
    DetRandomSelectAug (reference: detection.py
    CreateMultiRandCropAugmenter).  Scalar parameters broadcast against
    list-valued ones; all lists must share one length."""
    params = [min_object_covered, aspect_ratio_range, area_range,
              min_eject_coverage, max_attempts]
    cols = [p if isinstance(p, list) else [p] for p in params]
    n = max(len(c) for c in cols)
    for i, c in enumerate(cols):
        if len(c) != n:
            if len(c) != 1:
                raise ValueError("parameter lists must have equal length")
            cols[i] = c * n
    augs = [DetRandomCropAug(min_object_covered=moc, aspect_ratio_range=arr,
                             area_range=ar, min_eject_coverage=mec,
                             max_attempts=ma)
            for moc, arr, ar, mec, ma in zip(*cols)]
    return DetRandomSelectAug(augs, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 3.0),
                       min_eject_coverage=0.3, max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Standard detection augmenter stack (reference: detection.py:482).

    Ordering matches the reference: resize -> random crop -> mirror ->
    random pad -> force resize to data_shape -> cast -> photometric
    jitter -> normalize.  Geometry before the force-resize keeps the pad
    cheap; photometrics after it run on the small image.
    """
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        auglist.append(CreateMultiRandCropAugmenter(
            min_object_covered, aspect_ratio_range, area_range,
            min_eject_coverage, max_attempts, skip_prob=(1 - rand_crop)))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        auglist.append(DetRandomSelectAug(
            [DetRandomPadAug(aspect_ratio_range, (1.0, area_range[1]),
                             max_attempts, pad_val)],
            skip_prob=1 - rand_pad))
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


# ------------------------------------------------------ iterator


class ImageDetIter(ImageIter):
    """Detection record/list iterator (reference: detection.py:624).

    Reads the same .rec/.lst/imglist sources as ImageIter; labels are
    flat packed-header vectors (see module docstring) parsed into
    per-object rows, augmented jointly with the image, and batched with
    -1 row padding to a fixed (max_objects, obj_width) label shape, so
    that every batch has one shape.
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, shuffle=False,
                 part_index=0, num_parts=1, aug_list=None, imglist=None,
                 data_name="data", label_name="label",
                 preprocess_threads=0, **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         part_index=part_index, num_parts=num_parts,
                         aug_list=[], imglist=imglist, data_name=data_name,
                         label_name=label_name)
        self.auglist = (CreateDetAugmenter(data_shape, **kwargs)
                        if aug_list is None else aug_list)
        # optional thread pool for the per-sample decode+augment chain
        # (reference: iter_image_det_recordio.cc runs it in the worker
        # threads; the decoders and resizes release the GIL, so threads
        # overlap the pixel work while record reads stay on the calling
        # thread).  Each sample's seed is drawn on the calling thread and
        # the workers draw from per-sample generators
        # (_SampleScopedStream), so the pool's scheduling cannot change a
        # batch.
        self._executor = None
        if preprocess_threads and int(preprocess_threads) > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=int(preprocess_threads))
        self.label_shape = self._scan_label_shape()

    # -- label plumbing

    @property
    def provide_label(self):
        return [_io.DataDesc(self._label_name,
                             (self.batch_size,) + self.label_shape)]

    def _parse_label(self, label):
        """Flat packed vector -> (N, obj_width) object rows, dropping
        degenerate boxes (reference: detection.py _parse_label)."""
        if isinstance(label, ndarray.NDArray):
            label = label.asnumpy()
        flat = _np.asarray(label, dtype=_np.float32).ravel()
        if flat.size < 7:
            raise RuntimeError("packed det label too short: %d" % flat.size)
        head, owidth = int(flat[0]), int(flat[1])
        if head < 2 or owidth < 5 or (flat.size - head) % owidth:
            raise RuntimeError(
                "bad det label: header %d obj_width %d size %d"
                % (head, owidth, flat.size))
        rows = flat[head:].reshape(-1, owidth)
        ok = (rows[:, 3] > rows[:, 1]) & (rows[:, 4] > rows[:, 2])
        if not ok.any():
            raise RuntimeError("sample has no valid box")
        return rows[ok]

    def _check_valid_label(self, label):
        if label.ndim != 2 or label.shape[1] < 5:
            raise RuntimeError("label rows must be (N, 5+), got %s"
                               % (label.shape,))
        ok = ((label[:, 0] >= 0) & (label[:, 3] > label[:, 1])
              & (label[:, 4] > label[:, 2]))
        if not ok.any():
            raise RuntimeError("no valid box after augmentation")

    def _scan_label_shape(self):
        """One pass over the epoch to find the max object count — the
        static label shape (reference: _estimate_label_shape).  Samples
        with unparsable labels are skipped, matching next()'s skip
        behavior (the reference crashes here; tolerating stragglers at
        both sites is strictly more useful)."""
        max_objs, width = 0, 5
        self.reset()
        try:
            while True:
                raw, _ = self.next_sample()
                try:
                    rows = self._parse_label(raw)
                except RuntimeError as e:
                    logging.debug("label scan skipping bad sample: %s", e)
                    continue
                max_objs = max(max_objs, rows.shape[0])
                width = rows.shape[1]
        except StopIteration:
            pass
        if max_objs == 0:
            raise RuntimeError("no sample carries a valid detection label")
        self.reset()
        return (max_objs, width)

    def reshape(self, data_shape=None, label_shape=None):
        """Adopt a new data or label shape (reference: ImageDetIter.reshape)."""
        if data_shape is not None:
            if len(data_shape) != 3:
                raise ValueError("data_shape must be (C, H, W)")
            self.data_shape = tuple(data_shape)
            # retarget the force-resize so batches actually come out at
            # the new shape (the reference leaves a stale augmenter here)
            for aug in self.auglist:
                if (isinstance(aug, DetBorrowAug)
                        and isinstance(aug.augmenter, ForceResizeAug)):
                    aug.augmenter.size = (data_shape[2], data_shape[1])
        if label_shape is not None:
            self.check_label_shape(label_shape)
            self.label_shape = tuple(label_shape)

    def check_label_shape(self, label_shape):
        if len(label_shape) != 2:
            raise ValueError("label_shape must be (max_objects, obj_width)")
        if label_shape[0] < self.label_shape[0]:
            raise ValueError("cannot shrink max_objects %d -> %d"
                             % (self.label_shape[0], label_shape[0]))
        if label_shape[1] != self.label_shape[1]:
            raise ValueError("obj_width mismatch: %d vs %d"
                             % (self.label_shape[1], label_shape[1]))

    def sync_label_shape(self, it, verbose=False):
        """Grow both iterators to a common label shape so train/val
        batches share one static shape (reference: sync_label_shape)."""
        if not isinstance(it, ImageDetIter):
            raise TypeError("sync_label_shape needs another ImageDetIter")
        if self.label_shape[1] != it.label_shape[1]:
            raise ValueError("obj_width mismatch")
        top = max(self.label_shape[0], it.label_shape[0])
        if top > self.label_shape[0]:
            self.reshape(None, (top, self.label_shape[1]))
        if top > it.label_shape[0]:
            it.reshape(None, (top, it.label_shape[1]))
        if verbose:
            logging.info("synced det label shape to %s", (self.label_shape,))
        return it

    # -- batching

    def augmentation_transform(self, data, label):
        for aug in self.auglist:
            data, label = aug(data, label)
        return data, label

    # a bad sample is skipped, not fatal: RuntimeError covers label/
    # augment validation and cv2-backed decode (MXNetError), OSError
    # covers PIL's UnidentifiedImageError on the no-cv2 fallback, and
    # ValueError covers malformed buffers in either decoder
    _SKIP_ERRORS = (RuntimeError, OSError, ValueError)

    def _log_skip(self, err):
        """Per-sample data loss must be OBSERVABLE at default log
        level: warn for the first few skips (and periodically after),
        count all of them (``self.skipped_samples``)."""
        self.skipped_samples = getattr(self, "skipped_samples", 0) + 1
        n = self.skipped_samples
        if n <= 20 or n % 1000 == 0:
            logging.warning("skipping invalid det sample (%d skipped so "
                            "far): %s", n, err)
        else:
            logging.debug("skipping invalid det sample: %s", err)

    def close(self):
        """Release the preprocess thread pool (also runs on GC)."""
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def _load_one(self, raw, buf, seed=None):
        """Per-sample decode + joint augment (thread-pool work item).

        `seed` is a calling-thread draw from the global RNG: when set,
        every augmenter draw for THIS sample comes from generators
        seeded with it, so threaded batches reproduce under
        random.seed/np.random.seed regardless of which pool thread runs
        the sample."""
        from .image import _HostArray, _imdecode_np, _nprand

        if seed is not None:
            _rand.set_sample_rng(random.Random(seed))
            _nprand.set_sample_rng(_np.random.RandomState(seed & 0xffffffff))
        try:
            rows = self._parse_label(raw)
            # the whole per-sample path stays on host numpy; the card
            # sees one copy a batch
            img = _imdecode_np(buf).view(_HostArray)
            img, rows = self.augmentation_transform(img, rows)
            self._check_valid_label(rows)
            return img, rows
        finally:
            if seed is not None:
                _rand.set_sample_rng(None)
                _nprand.set_sample_rng(None)

    def _write_slot(self, batch_data, batch_label, i, img, rows):
        from .image import _to_host

        batch_data[i] = _to_host(img).transpose(2, 0, 1)
        n = min(rows.shape[0], self.label_shape[0])
        batch_label[i, :n] = rows[:n]

    def next(self):
        c_h_w = (self.data_shape[0],) + tuple(self.data_shape[1:])
        batch_data, dtok = self._stage.take((self.batch_size,) + c_h_w,
                                            _np.float32, self._device)
        batch_label, ltok = self._stage.take(
            (self.batch_size,) + self.label_shape, _np.float32, self._device)
        batch_data[:] = 0.0
        batch_label[:] = -1.0
        i = 0
        exhausted = False
        try:
            while i < self.batch_size and not exhausted:
                if self._executor is None:
                    raw, buf = self.next_sample()  # may StopIteration
                    try:
                        img, rows = self._load_one(raw, buf)
                    except self._SKIP_ERRORS as e:
                        self._log_skip(e)
                        continue
                    self._write_slot(batch_data, batch_label, i, img, rows)
                    i += 1
                    continue
                # threaded: record reads stay on this thread (recordio
                # handles are not thread-safe); decode+augment fans out
                samples = []
                while len(samples) < self.batch_size - i:
                    try:
                        samples.append(self.next_sample())
                    except StopIteration:
                        exhausted = True
                        break
                if not samples:
                    break
                # per-sample seeds drawn HERE, on the calling thread, so
                # the global stream advances deterministically in sample
                # order and thread scheduling cannot change batch content
                futures = [self._executor.submit(self._load_one, raw, buf,
                                                 random.getrandbits(63))
                           for raw, buf in samples]
                for f in futures:
                    try:
                        img, rows = f.result()
                    except self._SKIP_ERRORS as e:
                        self._log_skip(e)
                        continue
                    self._write_slot(batch_data, batch_label, i, img, rows)
                    i += 1
        except StopIteration:
            exhausted = True
        if i == 0:
            raise StopIteration
        return _io.DataBatch(data=[self._stage.send(dtok, self._device)],
                             label=[self._stage.send(ltok, self._device)],
                             pad=self.batch_size - i)
