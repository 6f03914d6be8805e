"""``mx.image`` of the PyTorch port: image decoding, resizing and crops,
the augmenters, ``CreateAugmenter`` and ``ImageIter``.

Counterpart of ``mxnet_tpu/image.py`` (reference: python/mxnet/image/
image.py over src/io/image_aug_default.cc).  Decoding (cv2, else PIL)
and augmentation run on host numpy; an NDArray given to a function or an
augmenter gives an NDArray back on its context, a numpy array a numpy
array (:func:`_to_host`, :func:`_like`).  The augmenters draw from
numpy's global stream (``np.random``) in the JAX package's order, so a
seeded run draws the same values in both packages; a preprocess thread
may install a per-sample generator instead (:class:`_SampleScopedStream`).
An :class:`ImageIter` batch is assembled on the host and copied once to
the current context (through a ring of page-locked blocks on the card).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from . import ndarray, recordio
from .base import MXNetError
from .context import cpu, resolve_device
from .io import io as _io

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "random_size_crop",
           "color_normalize", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "LightingAug",
           "ColorJitterAug", "RandomOrderAug", "RandomGrayAug",
           "SequentialAug", "CreateAugmenter", "ImageIter"]


def _cv2():
    if recordio.codec(("cv2",)) is None:
        return None
    import cv2

    return cv2


class _HostArray(np.ndarray):
    """A numpy view that answers ``asnumpy`` too, so an augmenter written
    against NDArrays runs on the iterators' host arrays."""

    def asnumpy(self):
        return np.asarray(self)


def _to_host(src):
    """An NDArray or numpy array as a host numpy array."""
    return src.asnumpy() if isinstance(src, ndarray.NDArray) else src


def _like(out, ref):
    """``out`` (numpy) in the container ``ref`` came in: an NDArray on
    ``ref``'s context, else a host array."""
    if isinstance(ref, ndarray.NDArray):
        return ndarray.array(out, ctx=ref.context)
    return out.view(_HostArray) if isinstance(out, np.ndarray) else out


def _imdecode_np(buf, flag=1, to_rgb=True):
    """An encoded image's HWC uint8 numpy array (a grayscale one with one
    channel), by cv2, else PIL."""
    if bytes(buf[:4]) == b"IMG0":
        buf = buf[4:]
    kind = recordio.codec(("cv2", "PIL"))
    if kind == "cv2":
        import cv2

        arr = cv2.imdecode(np.frombuffer(buf, dtype=np.uint8),
                           cv2.IMREAD_COLOR if flag else cv2.IMREAD_GRAYSCALE)
        if arr is None:
            raise MXNetError("imdecode failed")
        if flag and to_rgb:
            arr = arr[:, :, ::-1]
        if not flag:
            arr = arr[:, :, None]
    elif kind == "PIL":
        import io as _pyio

        from PIL import Image

        img = Image.open(_pyio.BytesIO(buf)).convert("RGB" if flag else "L")
        arr = np.asarray(img)
        if not flag:
            arr = arr[:, :, None]
        elif not to_rgb:
            arr = arr[:, :, ::-1]
    else:
        raise recordio._no_codec("imdecode")
    return np.ascontiguousarray(arr)


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """An encoded image as an HWC uint8 NDArray on the host (RGB unless
    ``to_rgb`` is False)."""
    del out
    return ndarray.array(_imdecode_np(buf, flag=flag, to_rgb=to_rgb),
                         ctx=cpu(), dtype="uint8")


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def _cv2_interp(interp):
    import cv2

    return {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR, 2: cv2.INTER_CUBIC,
            3: cv2.INTER_AREA, 4: cv2.INTER_LANCZOS4}.get(int(interp),
                                                          cv2.INTER_LINEAR)


def imresize(src, w, h, interp=1):
    """``src`` (HWC) resized to ``w`` x ``h``: cv2's resize, else the
    bilinear numpy resize of ``gluon.data.vision.transforms``; the
    dtype and container stay."""
    arr = _to_host(src)
    cv2 = _cv2()
    if cv2 is not None:
        out = cv2.resize(arr, (int(w), int(h)),
                         interpolation=_cv2_interp(interp))
        if out.ndim == 2:
            out = out[:, :, None]
    else:
        from .gluon.data.vision.transforms import _resize_np

        out = _resize_np(arr, (int(w), int(h)))
    return _like(out.astype(arr.dtype, copy=False), src)


def resize_short(src, size, interp=2):
    """``src`` resized so that its shorter side is ``size``."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = _like(_to_host(src)[y0:y0 + h, x0:x0 + w], src)
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h)
    return out, (x0, y0, new_w, new_h)


class _SampleScopedStream:
    """The stream the augmenters draw from: ``fallback`` (numpy's global
    stream here, the ``random`` module in :mod:`.image_detection`), or a
    generator a preprocess thread installs for its sample, seeded by a
    draw the calling thread made, so that a threaded batch does not hang
    on which thread ran which sample."""

    def __init__(self, fallback):
        self._fallback = fallback
        self._local = threading.local()

    def set_sample_rng(self, rng):
        self._local.rng = rng

    def __getattr__(self, name):
        rng = getattr(self._local, "rng", None)
        return getattr(self._fallback if rng is None else rng, name)


_nprand = _SampleScopedStream(np.random)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _nprand.randint(0, w - new_w + 1)
    y0 = _nprand.randint(0, h - new_h + 1)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _nprand.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(_nprand.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = _nprand.randint(0, w - new_w + 1)
            y0 = _nprand.randint(0, h - new_h + 1)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std`` in float32; either may be None."""
    arr = _to_host(src).astype(np.float32)
    if mean is not None:
        arr = arr - np.asarray(mean, dtype=np.float32)
    if std is not None:
        arr = arr / np.asarray(std, dtype=np.float32)
    return _like(arr, src)


# ------------------------------------------------------------- augmenters


class Augmenter:
    """An image augmenter: ``aug(src)`` gives the augmented image;
    ``dumps()`` its class and arguments as JSON."""

    def __init__(self, **kwargs):
        self._kwargs = {
            k: (v.asnumpy().tolist() if isinstance(v, ndarray.NDArray)
                else v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in kwargs.items()}

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _nprand.rand() < self.p:
            return _like(_to_host(src)[:, ::-1].copy(), src)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        if isinstance(src, ndarray.NDArray):
            return src.astype(self.typ)
        return src.astype(self.typ, copy=False)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


_GRAY = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _nprand.uniform(-self.brightness, self.brightness)
        return _like(_to_host(src).astype(np.float32) * alpha, src)


class ContrastJitterAug(Augmenter):
    _coef = _GRAY

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _nprand.uniform(-self.contrast, self.contrast)
        arr = _to_host(src).astype(np.float32)
        gray = (arr * self._coef).sum() * (3.0 / arr.size)
        return _like(arr * alpha + gray * (1.0 - alpha), src)


class SaturationJitterAug(Augmenter):
    _coef = _GRAY

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _nprand.uniform(-self.saturation, self.saturation)
        arr = _to_host(src).astype(np.float32)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        return _like(arr * alpha + gray * (1.0 - alpha), src)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        """A rotation of the YIQ hue by up to ``hue`` half-turns."""
        alpha = _nprand.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        tyiq = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]])
        ityiq = np.array([[1.0, 0.956, 0.621], [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]])
        t = np.dot(np.dot(ityiq, bt), tyiq).T
        arr = _to_host(src).astype(np.float32)
        return _like(np.dot(arr, t).astype(np.float32), src)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)

    def __call__(self, src):
        alpha = _nprand.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return _like(_to_host(src).astype(np.float32) + rgb, src)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness, contrast, saturation):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.augs = []
        if brightness > 0:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation > 0:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        for i in _nprand.permutation(len(self.augs)):
            src = self.augs[i](src)
        return src


class RandomGrayAug(Augmenter):
    """Three-channel grayscale with probability ``p``."""

    _coef = _GRAY

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _nprand.rand() < self.p:
            arr = _to_host(src).astype(np.float32)
            gray = (arr * self._coef).sum(axis=2, keepdims=True)
            return _like(np.broadcast_to(
                gray, gray.shape[:2] + (3,)).copy(), src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for i in _nprand.permutation(len(self.ts)):
            src = self.ts[i](src)
        return src


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class _RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__()
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, (self.area, 1.0), self.ratio,
                                self.interp)[0]


_PCA_EIGVAL = np.array([55.46, 4.794, 1.148])
_PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]])


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list: resize, a crop to ``data_shape``
    (random-sized, random or central), mirror, cast, colour jitter, hue,
    PCA lighting, gray, normalisation."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(_RandomSizedCropAug(crop_size, 0.08,
                                           (3.0 / 4.0, 4.0 / 3.0),
                                           inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, _PCA_EIGVAL, _PCA_EIGVEC))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is not None and len(np.atleast_1d(mean)) > 0:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ------------------------------------------------------------- ImageIter


class ImageIter(_io.DataIter):
    """Batches of images from a record file (``path_imgrec`` with its
    ``.idx``), an image list file (``path_imglist`` under ``path_root``)
    or an ``imglist`` of ``(label, path)``, each decoded and run through
    ``aug_list`` (default :func:`CreateAugmenter` of ``kwargs``): NCHW
    float32 data and ``(batch,)`` labels (``(batch, label_width)`` when
    wider) on the current context; a short last batch is zero-padded
    and says so in ``pad``."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 part_index=0, num_parts=1, aug_list=None, imglist=None,
                 shuffle=False, data_name="data", label_name="softmax_label",
                 **kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self._data_name = data_name
        self._label_name = label_name
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self._device = resolve_device(None)
        self._stage = _io._BatchStage()
        self.seq = None
        self.imgrec = None
        self.imglist = None
        self.path_root = path_root
        if path_imgrec:
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                     "r")
            self.seq = list(self.imgrec.keys)
        elif path_imglist:
            with open(path_imglist) as f:
                result = {}
                for line in f:
                    parts = line.strip().split("\t")
                    label = np.array(parts[1:-1], dtype=np.float32)
                    result[int(parts[0])] = (label, parts[-1])
            self.imglist = result
            self.seq = list(result.keys())
        elif imglist is not None:
            result = {}
            for i, item in enumerate(imglist):
                result[i] = (np.asarray(item[0], dtype=np.float32)
                             if not np.isscalar(item[0])
                             else np.array([item[0]], dtype=np.float32),
                             item[1])
            self.imglist = result
            self.seq = list(result.keys())
        else:
            raise ValueError("must supply path_imgrec, path_imglist or "
                             "imglist")
        if num_parts > 1:
            self.seq = self.seq[part_index::num_parts]
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [_io.DataDesc(self._data_name,
                             (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [_io.DataDesc(self._label_name, shape)]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.seq)
        self.cur = 0

    def next_sample(self):
        """``(label, encoded image bytes)`` of the next sample."""
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            header, img = recordio.unpack(self.imgrec.read_idx(idx))
            return header.label, img
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root or "", fname), "rb") as f:
            return label, f.read()

    def next(self):
        data, dtok = self._stage.take((self.batch_size,) + self.data_shape,
                                      np.float32, self._device)
        label, ltok = self._stage.take((self.batch_size, self.label_width),
                                       np.float32, self._device)
        i = 0
        try:
            while i < self.batch_size:
                lab, buf = self.next_sample()
                img = _imdecode_np(buf).view(_HostArray)
                for aug in self.auglist:
                    img = aug(img)
                data[i] = _to_host(img).transpose(2, 0, 1)
                label[i] = np.atleast_1d(lab)[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        data[i:] = 0.0
        label[i:] = 0.0
        label_nd = self._stage.send(ltok, self._device)
        if self.label_width == 1:
            label_nd = label_nd.reshape((self.batch_size,))
        return _io.DataBatch(data=[self._stage.send(dtok, self._device)],
                             label=[label_nd], pad=self.batch_size - i)


# the detection augmenters and ImageDetIter, in mx.image as in MXNet
from .image_detection import (  # noqa: E402
    CreateDetAugmenter, CreateMultiRandCropAugmenter, DetAugmenter,
    DetBorrowAug, DetHorizontalFlipAug, DetRandomCropAug, DetRandomPadAug,
    DetRandomSelectAug, ImageDetIter)

__all__ += ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
            "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
            "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
            "ImageDetIter"]
