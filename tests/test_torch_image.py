"""The port's ``mx.image`` (mxnet_tpu_torch/image.py) against the JAX
package's, on the CPU: decoding, the resize and crop helpers, each of the
augmenters, ``CreateAugmenter`` and ``ImageIter``'s batches.

Both packages run the same host numpy (and cv2 or PIL) code on the same
seeded inputs, with numpy's global stream seeded alike before each call,
so every comparison is exact.
"""

import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import image as timage

EIGVAL = [55.46, 4.794, 1.148]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]


def _img(seed=0, hw=(24, 30)):
    return np.random.RandomState(seed).randint(0, 256, size=hw + (3,),
                                               dtype=np.uint8)


def _both(fn, seed=11):
    """``fn(package)`` with numpy's global stream seeded alike before
    each package's call."""
    out = []
    for pkg in (timage, jimage):
        np.random.seed(seed)
        out.append(fn(pkg))
    return out


def _np(x):
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def test_imdecode_and_imread_match(tmp_path):
    img = _img()
    rec = jrec.pack_img(jrec.IRHeader(0, 0.0, 0, 0), img, quality=85)
    _, buf = jrec.unpack(rec)
    for flag in (0, 1):
        for to_rgb in (True, False):
            got = timage.imdecode(buf, flag=flag, to_rgb=to_rgb)
            want = jimage.imdecode(buf, flag=flag, to_rgb=to_rgb)
            assert got.context == tmx.cpu()
            assert str(got.dtype) == "uint8" or got.dtype == np.uint8
            np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    path = tmp_path / "x.jpg"
    path.write_bytes(bytes(buf))
    np.testing.assert_array_equal(timage.imread(str(path)).asnumpy(),
                                  jimage.imread(str(path)).asnumpy())


@pytest.mark.parametrize("call", [
    lambda p, x: p.imresize(x, 13, 9),
    lambda p, x: p.imresize(x, 40, 31, interp=2),
    lambda p, x: p.resize_short(x, 16),
    lambda p, x: p.fixed_crop(x, 3, 2, 10, 8),
    lambda p, x: p.fixed_crop(x, 3, 2, 10, 8, size=(6, 5)),
    lambda p, x: p.center_crop(x, (11, 7)),
    lambda p, x: p.random_crop(x, (11, 7)),
    lambda p, x: p.random_size_crop(x, (10, 10), 0.3, (0.75, 1.33)),
    lambda p, x: p.color_normalize(x, [120.0, 110.0, 100.0],
                                   [60.0, 55.0, 50.0]),
    lambda p, x: p.color_normalize(x, None, [60.0, 55.0, 50.0]),
], ids=["imresize", "imresize-cubic", "resize_short", "fixed_crop",
        "fixed_crop-resized", "center_crop", "random_crop",
        "random_size_crop", "color_normalize", "color_normalize-std"])
@pytest.mark.parametrize("container", ["ndarray", "numpy"])
def test_helpers_match(call, container):
    img = _img(1)

    def run(pkg):
        x = img if container == "numpy" else \
            (tmx.nd.array(img, ctx=tmx.cpu(), dtype="uint8")
             if pkg is timage else jmx.nd.array(img, dtype="uint8"))
        out = call(pkg, x)
        return out if isinstance(out, tuple) else (out,)

    got, want = _both(run)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if container == "ndarray" and hasattr(w, "asnumpy"):
            assert isinstance(g, tmx.nd.NDArray)
        np.testing.assert_array_equal(_np(g), _np(w))


AUGMENTERS = {
    "ResizeAug": lambda p: p.ResizeAug(14),
    "ForceResizeAug": lambda p: p.ForceResizeAug((12, 9)),
    "RandomCropAug": lambda p: p.RandomCropAug((12, 9)),
    "CenterCropAug": lambda p: p.CenterCropAug((12, 9)),
    "HorizontalFlipAug": lambda p: p.HorizontalFlipAug(0.5),
    "CastAug": lambda p: p.CastAug(),
    "ColorNormalizeAug": lambda p: p.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1, 57.4])),
    "BrightnessJitterAug": lambda p: p.BrightnessJitterAug(0.4),
    "ContrastJitterAug": lambda p: p.ContrastJitterAug(0.4),
    "SaturationJitterAug": lambda p: p.SaturationJitterAug(0.4),
    "HueJitterAug": lambda p: p.HueJitterAug(0.3),
    "LightingAug": lambda p: p.LightingAug(0.1, EIGVAL, EIGVEC),
    "ColorJitterAug": lambda p: p.ColorJitterAug(0.3, 0.3, 0.3),
    "RandomOrderAug": lambda p: p.RandomOrderAug(
        [p.BrightnessJitterAug(0.2), p.HueJitterAug(0.1),
         p.HorizontalFlipAug(0.5)]),
    "RandomGrayAug": lambda p: p.RandomGrayAug(0.5),
    "SequentialAug": lambda p: p.SequentialAug(
        [p.RandomCropAug((12, 9)), p.CastAug(), p.LightingAug(
            0.1, EIGVAL, EIGVEC)]),
}


def test_every_augmenter_is_covered():
    names = {n for n in jimage.__all__ if n.endswith("Aug")
             and not n.startswith("Det")}
    assert names == set(AUGMENTERS)
    assert issubclass(timage.ResizeAug, timage.Augmenter)


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
@pytest.mark.parametrize("container", ["ndarray", "numpy"])
def test_augmenter_matches(name, container):
    make = AUGMENTERS[name]
    for seed in (0, 1, 2):
        img = _img(seed).astype(np.float32) if name == "HueJitterAug" \
            else _img(seed)

        def run(pkg):
            aug = make(pkg)
            if container == "numpy":
                return aug(img), aug.dumps()
            x = tmx.nd.array(img, ctx=tmx.cpu()) if pkg is timage \
                else jmx.nd.array(img)
            return aug(x), aug.dumps()

        (got, gdump), (want, wdump) = _both(run, seed=20 + seed)
        assert gdump == wdump
        if container == "ndarray":
            assert isinstance(got, tmx.nd.NDArray)
            assert got.context == tmx.cpu()
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("kwargs", [
    {},
    {"resize": 20, "rand_crop": True, "rand_mirror": True, "mean": True,
     "std": True},
    {"rand_resize": True, "brightness": 0.2, "contrast": 0.2,
     "saturation": 0.2, "hue": 0.1, "pca_noise": 0.1, "rand_gray": 0.3,
     "mean": np.array([1.0, 2.0, 3.0])},
], ids=["default", "crop-mirror-normalize", "everything"])
def test_create_augmenter_matches(kwargs):
    shape = (3, 14, 12)
    got = timage.CreateAugmenter(shape, **kwargs)
    want = jimage.CreateAugmenter(shape, **kwargs)
    assert [a.dumps() for a in got] == [a.dumps() for a in want]
    img = _img(4)

    def run(pkg):
        x = img.view(pkg._HostArray)
        for aug in (got if pkg is timage else want):
            x = aug(x)
        return np.asarray(x)

    a, b = _both(run)
    np.testing.assert_array_equal(a, b)


def _rec(tmp_path, n=11, seed=2):
    rs = np.random.RandomState(seed)
    p = str(tmp_path / "imgs")
    w = jrec.MXIndexedRecordIO(p + ".idx", p + ".rec", "w")
    for i in range(n):
        hw = (18 + i % 3, 20 + i % 4)
        img = rs.randint(0, 256, size=hw + (3,), dtype=np.uint8)
        label = float(i % 4) if i % 3 else \
            np.array([i % 4, i / 10.0], np.float32)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, label, i, 0), img))
    w.close()
    return p


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


@pytest.mark.parametrize("source", ["rec", "imglist"])
@pytest.mark.parametrize("kwargs", [
    {},
    {"shuffle": True, "rand_crop": True, "rand_mirror": True,
     "mean": True, "std": True, "num_parts": 2, "part_index": 1},
    {"label_width": 2, "resize": 16, "brightness": 0.2},
], ids=["plain", "shuffled-sharded", "wide-label"])
def test_image_iter_batches_match(tmp_path, source, kwargs):
    p = _rec(tmp_path)
    shape = (3, 16, 16)
    if source == "rec":
        src = {"path_imgrec": p + ".rec"}
    else:
        root = tmp_path / "files"
        os.makedirs(root)
        imglist = []
        r = jrec.MXIndexedRecordIO(p + ".idx", p + ".rec", "r")
        for k in r.keys:
            hdr, buf = jrec.unpack(r.read_idx(k))
            (root / ("%d.jpg" % k)).write_bytes(bytes(buf))
            imglist.append((hdr.label, "%d.jpg" % k))
        src = {"imglist": imglist, "path_root": str(root)}

    def run(pkg):
        it = pkg.ImageIter(4, shape, **src, **kwargs)
        assert it.provide_label[0][1] == ((4,) if kwargs.get(
            "label_width", 1) == 1 else (4, kwargs["label_width"]))
        first = _batches(it)
        it.reset()
        return first + _batches(it)

    with tmx.cpu():
        got, want = _both(run)
    assert len(got) == len(want) > 2
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    assert got[len(got) // 2 - 1][2] > 0  # the last batch was padded
