"""The port's detection augmenters and ``ImageDetIter``
(mxnet_tpu_torch/image_detection.py) against the JAX package's, on the
CPU, over records packed as ``example/ssd`` packs them (JPEG files and a
detection ``.lst`` through im2rec ``--pack-label``: a varying number of
objects a record).

Both packages run the same host numpy and codec code, drawing from the
``random`` module's and numpy's global streams seeded alike (threaded
samples from generators seeded by draws of the calling thread), so
batches and labels are compared exactly.
"""

import importlib.util
import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import image as timage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    spec = importlib.util.spec_from_file_location(
        "ssd_example_train_det", os.path.join(REPO, "example", "ssd",
                                              "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    ex = _example()
    d = tmp_path_factory.mktemp("det")
    scenes = ex.make_scenes(np.random.RandomState(0), 10, 48, 3, max_objs=3)
    return ex.write_rec(str(d), "scenes", scenes), scenes


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _run(pkg, path, epochs=2, seed=5, **kwargs):
    out = []
    with tmx.cpu():
        _seed(seed)
        it = pkg.ImageDetIter(batch_size=4, data_shape=(3, 40, 40),
                              path_imgrec=path, **kwargs)
        shape = it.label_shape
        for _ in range(epochs):
            for b in it:
                out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
            it.reset()
        if hasattr(it, "close"):
            it.close()
    return shape, out


@pytest.mark.parametrize("kwargs", [
    {},
    {"rand_mirror": True, "shuffle": True, "mean": True, "std": True},
    {"rand_crop": 1, "rand_pad": 0.5, "rand_mirror": True,
     "brightness": 0.2, "mean": True},
    {"rand_crop": 1, "rand_pad": 1, "preprocess_threads": 3},
    {"num_parts": 2, "part_index": 1, "rand_gray": 0.5, "hue": 0.1},
], ids=["plain", "mirror-shuffle-normalize", "crop-pad-jitter",
        "threaded", "sharded"])
def test_batches_and_labels_match(records, kwargs):
    path, _ = records
    gshape, got = _run(timage, path, **kwargs)
    wshape, want = _run(jimage, path, **kwargs)
    assert gshape == wshape
    assert len(got) == len(want) >= 2
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp and gd.shape == wd.shape and gl.shape == wl.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_labels_are_the_records_own(records):
    """Without augmentation the batches' labels are each record's
    objects, -1 rows after them up to the epoch's largest count."""
    path, scenes = records
    shape, got = _run(timage, path, epochs=1)
    assert shape == (max(len(rows) for _, rows in scenes), 5)
    labels = np.concatenate([lab for _, lab, _ in got])[:len(scenes)]
    r = jrec.MXIndexedRecordIO(path[:-4] + ".idx", path, "r")
    for k, lab in zip(r.keys, labels):
        flat = jrec.unpack(r.read_idx(k))[0].label
        rows = np.asarray(flat[2:], np.float32).reshape(-1, 5)
        np.testing.assert_array_equal(lab[:len(rows)], rows)
        assert (lab[len(rows):] == -1).all()
    assert got[-1][2] == 2  # 10 records in batches of 4


@pytest.mark.parametrize("make", [
    lambda p: p.DetHorizontalFlipAug(0.5),
    lambda p: p.DetRandomCropAug(min_object_covered=0.3,
                                 area_range=(0.2, 1.0)),
    lambda p: p.DetRandomPadAug(area_range=(1.0, 2.5)),
    lambda p: p.DetRandomSelectAug([p.DetHorizontalFlipAug(1.0),
                                    p.DetRandomPadAug()], skip_prob=0.3),
    lambda p: p.DetBorrowAug(p.ForceResizeAug((20, 16))),
    lambda p: p.CreateMultiRandCropAugmenter(
        min_object_covered=[0.1, 0.5], area_range=(0.3, 1.0)),
], ids=["flip", "crop", "pad", "select", "borrow", "multi-crop"])
def test_each_det_augmenter_matches(make):
    img = np.random.RandomState(1).randint(0, 256, (30, 40, 3), np.uint8)
    label = np.array([[0, 0.1, 0.2, 0.5, 0.6], [2, 0.4, 0.3, 0.9, 0.95]],
                     np.float32)
    for seed in range(4):
        outs = []
        for pkg, nd in ((timage, tmx.nd), (jimage, jmx.nd)):
            _seed(seed)
            aug = make(pkg)
            x = nd.array(img, ctx=tmx.cpu()) if pkg is timage \
                else nd.array(img)
            outs.append(aug(x, label.copy()) + (aug.dumps(),))
        (gimg, glab, gdump), (wimg, wlab, wdump) = outs
        assert gdump == wdump
        assert isinstance(gimg, tmx.nd.NDArray)
        np.testing.assert_array_equal(gimg.asnumpy(), wimg.asnumpy())
        np.testing.assert_array_equal(glab, wlab)


def test_create_det_augmenter_and_label_shapes(records):
    path, _ = records
    kw = {"rand_crop": 0.5, "rand_pad": 0.5, "rand_mirror": True,
          "mean": True, "std": True, "brightness": 0.1, "pca_noise": 0.1}
    got = timage.CreateDetAugmenter((3, 32, 32), **kw)
    want = jimage.CreateDetAugmenter((3, 32, 32), **kw)
    assert [str(a.dumps()) for a in got] == [str(a.dumps()) for a in want]
    with tmx.cpu():
        a = timage.ImageDetIter(2, (3, 32, 32), path_imgrec=path)
        b = timage.ImageDetIter(2, (3, 32, 32), path_imgrec=path)
    b.reshape(label_shape=(a.label_shape[0] + 2, 5))
    a.sync_label_shape(b)
    assert a.label_shape == b.label_shape == (a.label_shape[0], 5)
    assert a.provide_label[0][1] == (2,) + a.label_shape
    with pytest.raises(ValueError, match="shrink"):
        a.reshape(label_shape=(1, 5))
    a.reshape(data_shape=(3, 24, 24))
    with tmx.cpu():
        batch = a.next()
    assert batch.data[0].shape == (2, 3, 24, 24)
    assert batch.label[0].shape == (2,) + a.label_shape
