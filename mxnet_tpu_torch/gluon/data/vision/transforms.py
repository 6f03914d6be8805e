"""Vision transforms of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py`` (reference:
python/mxnet/gluon/data/vision/transforms.py): the 16 classes from
``Compose`` to ``RandomColorJitter``, in the JAX package's arithmetic on
host numpy, drawing from numpy's global generator as it does.  A
transform takes an NDArray (anywhere), a tensor or a numpy array and
gives a host NDArray (``Cast`` keeps its input's place); the DataLoader
copies each batch to its context once.
"""

from __future__ import annotations

import numpy as _np

import torch

from .... import ndarray
from ....context import cpu
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomLighting", "RandomColorJitter"]


def _as_np(x):
    if isinstance(x, ndarray.NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


def _host(arr, dtype=None):
    return ndarray.array(arr, ctx=cpu(), dtype=dtype)


class _Transform(Block):
    """A transform: a block that runs where its input lies, on whatever
    kind of array it is given."""

    _placeless = True


class Compose(Sequential):
    """Chain transforms (reference: transforms.py Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(_Transform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        if isinstance(x, torch.Tensor):
            x = ndarray.NDArray(x)
        return x.astype(self._dtype)


class ToTensor(_Transform):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference: transforms.py
    ToTensor over src/operator/image/totensor)."""

    def __init__(self):
        super().__init__()

    def forward(self, x):
        arr = _as_np(x).astype(_np.float32) / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return _host(arr)


class Normalize(_Transform):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, dtype=_np.float32)
        self._std = _np.asarray(std, dtype=_np.float32)

    def forward(self, x):
        arr = _as_np(x)
        mean = self._mean.reshape((-1, 1, 1)) if self._mean.ndim \
            else self._mean
        std = self._std.reshape((-1, 1, 1)) if self._std.ndim else self._std
        return _host((arr - mean) / std)


def _resize_np(arr, size, interp="bilinear"):
    """Bilinear resize HWC uint8/float via pure numpy."""
    h, w = arr.shape[:2]
    if isinstance(size, int):
        size = (size, size)
    ow, oh = size  # reference order: (width, height)
    if (oh, ow) == (h, w):
        return arr
    ys = _np.linspace(0, h - 1, oh)
    xs = _np.linspace(0, w - 1, ow)
    y0 = _np.floor(ys).astype(_np.int64)
    x0 = _np.floor(xs).astype(_np.int64)
    y1 = _np.minimum(y0 + 1, h - 1)
    x1 = _np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = arr[_np.ix_(y0, x0)].astype(_np.float32)
    b = arr[_np.ix_(y0, x1)].astype(_np.float32)
    c = arr[_np.ix_(y1, x0)].astype(_np.float32)
    d = arr[_np.ix_(y1, x1)].astype(_np.float32)
    out = a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + \
        c * wy * (1 - wx) + d * wy * wx
    if arr.dtype == _np.uint8:
        out = _np.clip(_np.rint(out), 0, 255).astype(_np.uint8)
    return out


class Resize(_Transform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        arr = _as_np(x)
        size = self._size
        if self._keep and isinstance(size, int):
            h, w = arr.shape[:2]
            if h < w:
                size = (int(w * size / h), size)
            else:
                size = (size, int(h * size / w))
        return _host(_resize_np(arr, size), dtype=arr.dtype)


class CenterCrop(_Transform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        arr = _as_np(x)
        ow, oh = self._size
        h, w = arr.shape[:2]
        if h < oh or w < ow:
            arr = _resize_np(arr, (max(ow, w), max(oh, h)))
            h, w = arr.shape[:2]
        y = (h - oh) // 2
        xo = (w - ow) // 2
        return _host(arr[y:y + oh, xo:xo + ow], dtype=arr.dtype)


class RandomResizedCrop(_Transform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        arr = _as_np(x)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            nw = int(round(_np.sqrt(target_area * aspect)))
            nh = int(round(_np.sqrt(target_area / aspect)))
            if nw <= w and nh <= h:
                y = _np.random.randint(0, h - nh + 1)
                xo = _np.random.randint(0, w - nw + 1)
                crop = arr[y:y + nh, xo:xo + nw]
                return _host(_resize_np(crop, self._size), dtype=arr.dtype)
        return CenterCrop(self._size).forward(_host(arr, dtype=arr.dtype))


class RandomFlipLeftRight(_Transform):
    def __init__(self):
        super().__init__()

    def forward(self, x):
        if _np.random.rand() < 0.5:
            return _host(_as_np(x)[:, ::-1].copy())
        return x


class RandomFlipTopBottom(_Transform):
    def __init__(self):
        super().__init__()

    def forward(self, x):
        if _np.random.rand() < 0.5:
            return _host(_as_np(x)[::-1].copy())
        return x


class _RandomJitter(_Transform):
    def __init__(self, magnitude):
        super().__init__()
        self._m = magnitude

    def _alpha(self):
        return 1.0 + _np.random.uniform(-self._m, self._m)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        arr = _as_np(x).astype(_np.float32) * self._alpha()
        return _host(arr)


class RandomContrast(_RandomJitter):
    def forward(self, x):
        arr = _as_np(x).astype(_np.float32)
        gray = arr.mean()
        return _host(gray + (arr - gray) * self._alpha())


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        arr = _as_np(x).astype(_np.float32)
        gray = arr.mean(axis=-1, keepdims=True)
        return _host(gray + (arr - gray) * self._alpha())


class RandomHue(_Transform):
    """YIQ hue rotation by a random angle in [-hue, hue] (reference:
    transforms.py RandomHue over image.py HueJitterAug)."""

    _tyiq = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], dtype=_np.float32)
    _ityiq = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], dtype=_np.float32)

    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        alpha = _np.random.uniform(-self._hue, self._hue)
        u, w = _np.cos(alpha * _np.pi), _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       dtype=_np.float32)
        t = (self._ityiq @ bt @ self._tyiq).T
        arr = _as_np(x).astype(_np.float32)
        return _host(arr @ t)


class RandomLighting(_Transform):
    """AlexNet-style PCA lighting noise (reference: transforms.py)."""

    _eigval = _np.array([55.46, 4.794, 1.148], dtype=_np.float32)
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], dtype=_np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        arr = _as_np(x).astype(_np.float32)
        alpha = _np.random.normal(0, self._alpha, size=(3,)).astype(
            _np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _host(arr + rgb)


class RandomColorJitter(_Transform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        order = _np.random.permutation(len(self._ts))
        for i in order:
            x = self._ts[i].forward(x)
        return x
