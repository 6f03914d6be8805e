"""``gluon.data`` of the PyTorch port against the JAX package.

The samplers and every ``last_batch`` mode give the JAX index sequences
exactly (the random ones from the same numpy seed); DataLoader batches
equal the JAX ones for ``shuffle=False`` (numpy, NDArray and tuple
samples, with and without worker threads), as NDArrays on the current
context; each of the 16 vision transforms is within 1e-6 of the JAX
package's on the same seeded image and numpy draws; the datasets read
the reference's files and raise, naming the path, when they are
missing.
"""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

jdata, tdata = jmx.gluon.data, tmx.gluon.data
jtf, ttf = jdata.vision.transforms, tdata.vision.transforms


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("length,batch", [(10, 4), (12, 4), (3, 5)])
def test_batch_sampler_modes_match_jax(last_batch, length, batch):
    t = tdata.BatchSampler(tdata.SequentialSampler(length), batch,
                           last_batch)
    j = jdata.BatchSampler(jdata.SequentialSampler(length), batch,
                           last_batch)
    for _ in range(3):  # a rollover carries into the next pass
        assert list(t) == list(j)
        assert len(t) == len(j)


def test_random_sampler_matches_jax_from_one_seed():
    np.random.seed(5)
    want = [list(jdata.RandomSampler(9)) for _ in range(2)]
    np.random.seed(5)
    got = [list(tdata.RandomSampler(9)) for _ in range(2)]
    assert got == want and sorted(got[0]) == list(range(9))
    with pytest.raises(ValueError, match="last_batch"):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "sometimes")


def _datasets(mx):
    rng = np.random.RandomState(0)
    x = rng.rand(11, 3, 4).astype(np.float32)
    y = rng.randint(0, 5, 11).astype(np.int32)
    return {"numpy": mx.gluon.data.ArrayDataset(x, y),
            "ndarray": mx.gluon.data.ArrayDataset(
                mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())),
            "single": mx.gluon.data.ArrayDataset(x),
            "simple": mx.gluon.data.SimpleDataset(
                [(x[i], float(y[i])) for i in range(11)])}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("kind", ["numpy", "ndarray", "single", "simple"])
def test_dataloader_batches_match_jax(kind, last_batch, workers):
    with tmx.cpu():
        tl = tdata.DataLoader(_datasets(tmx)[kind], batch_size=4,
                              last_batch=last_batch, num_workers=workers)
        n = len(tl)  # a rollover's carried samples count in the next pass
        got = [b if isinstance(b, list) else [b] for b in tl]
    jl = jdata.DataLoader(_datasets(jmx)[kind], batch_size=4,
                          last_batch=last_batch, num_workers=workers)
    want = [b if isinstance(b, list) else [b] for b in jl]
    assert len(got) == len(want) == n
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert isinstance(g, tmx.nd.NDArray)
            assert g.context == tmx.cpu()
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
            assert g.asnumpy().dtype == w.asnumpy().dtype


def test_dataset_helpers_match_jax():
    t, j = _datasets(tmx)["numpy"], _datasets(jmx)["numpy"]
    for op in (lambda d: d.take(3), lambda d: d.shard(3, 1),
               lambda d: d.shard(3, 2), lambda d: d.filter(lambda s: s[1] > 2),
               lambda d: d.transform(lambda a, b: (a * 2, b + 1), lazy=False),
               lambda d: d.transform_first(lambda a: a - 1)):
        gt, jt = op(t), op(j)
        assert len(gt) == len(jt)
        for i in range(len(gt)):
            for a, b in zip(gt[i], jt[i]):
                np.testing.assert_array_equal(_np(a), _np(b))


def test_batchify_and_custom_batch_sampler():
    samples = [(np.full((2,), i, np.float32), i) for i in range(5)]
    with tmx.cpu():
        x, y = tdata.default_batchify_fn(samples)
    jx, jy = jdata.default_batchify_fn(samples)
    np.testing.assert_array_equal(x.asnumpy(), jx.asnumpy())
    np.testing.assert_array_equal(y.asnumpy(), jy.asnumpy())
    assert y.asnumpy().dtype == np.int32
    bs = tdata.BatchSampler(tdata.SequentialSampler(5), 2, "discard")
    with tmx.cpu():
        loader = tdata.DataLoader(tdata.SimpleDataset(samples),
                                  batch_sampler=bs)
        assert [b[1].asnumpy().tolist() for b in loader] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError):
        tdata.DataLoader(tdata.SimpleDataset(samples), batch_sampler=bs,
                         batch_size=2)


def _transforms(mod):
    return [
        ("Compose", lambda: mod.Compose([mod.Cast("float32"),
                                         mod.Normalize(0.5, 0.25)])),
        ("Cast", lambda: mod.Cast("float16")),
        ("ToTensor", mod.ToTensor),
        ("Normalize", lambda: mod.Normalize((0.4, 0.5, 0.6),
                                            (0.2, 0.25, 0.3))),
        ("Resize", lambda: mod.Resize((10, 6))),
        ("Resize/keep_ratio", lambda: mod.Resize(5, keep_ratio=True)),
        ("CenterCrop", lambda: mod.CenterCrop((4, 6))),
        ("RandomResizedCrop", lambda: mod.RandomResizedCrop(6)),
        ("RandomFlipLeftRight", mod.RandomFlipLeftRight),
        ("RandomFlipTopBottom", mod.RandomFlipTopBottom),
        ("RandomBrightness", lambda: mod.RandomBrightness(0.3)),
        ("RandomContrast", lambda: mod.RandomContrast(0.3)),
        ("RandomSaturation", lambda: mod.RandomSaturation(0.3)),
        ("RandomHue", lambda: mod.RandomHue(0.2)),
        ("RandomLighting", lambda: mod.RandomLighting(0.1)),
        ("RandomColorJitter", lambda: mod.RandomColorJitter(0.2, 0.2, 0.2,
                                                            0.1)),
    ]


@pytest.mark.parametrize("index", range(16),
                         ids=[n for n, _ in _transforms(ttf)])
def test_each_transform_matches_jax(index):
    """The same HWC uint8 image (float32 for Normalize), the same numpy
    seed before each call: within 1e-6."""
    name, tmake = _transforms(ttf)[index]
    _, jmake = _transforms(jtf)[index]
    img = np.random.RandomState(index).randint(0, 256, (8, 12, 3)).astype(
        np.uint8)
    if name in ("Normalize", "Compose"):
        img = img.transpose(2, 0, 1).astype(np.float32) / 255.0
    for seed in range(3):
        np.random.seed(seed)
        with tmx.cpu():
            got = tmake()(tmx.nd.array(img, ctx=tmx.cpu(), dtype=img.dtype))
        np.random.seed(seed)
        want = jmake()(jmx.nd.array(img, dtype=img.dtype))
        assert isinstance(got, tmx.nd.NDArray) and got.context == tmx.cpu()
        np.testing.assert_allclose(got.asnumpy().astype(np.float64),
                                   want.asnumpy().astype(np.float64),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_transform_first_in_a_loader_gives_float_batches():
    x = np.random.RandomState(1).randint(0, 256, (6, 4, 4, 3)).astype(
        np.uint8)
    y = np.arange(6).astype(np.float32)
    tf = ttf.Compose([ttf.ToTensor(), ttf.Normalize(0.5, 0.5)])
    with tmx.cpu():
        ds = tdata.ArrayDataset(x, y).transform_first(tf)
        bx, by = next(iter(tdata.DataLoader(ds, batch_size=4)))
    assert bx.shape == (4, 3, 4, 4) and bx.dtype == np.float32
    want = (x[:4].transpose(0, 3, 1, 2) / 255.0 - 0.5) / 0.5
    np.testing.assert_allclose(bx.asnumpy(), want, rtol=0, atol=1e-6)
    assert by.asnumpy().tolist() == [0, 1, 2, 3]


def _write_mnist(root, n=7):
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    with gzip.open(os.path.join(root, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(os.path.join(root, "train-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def test_vision_datasets_read_files_and_name_missing_ones(tmp_path):
    root = str(tmp_path / "mnist")
    with pytest.raises(RuntimeError, match="train-images-idx3-ubyte.gz"):
        tdata.vision.MNIST(root=root)
    with pytest.raises(RuntimeError, match="cifar-10-python.tar.gz"):
        tdata.vision.CIFAR10(root=str(tmp_path / "cifar"))
    _write_mnist(root)
    t, j = tdata.vision.MNIST(root=root), jdata.vision.MNIST(root=root)
    assert len(t) == len(j) == 7
    for i in range(7):
        (ti, tl), (ji, jl) = t[i], j[i]
        np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
        assert ti.shape == (28, 28, 1) and tl == jl
    ts = tdata.vision.SyntheticImageDataset(5, (6, 6, 3), 4, seed=3)
    js = jdata.vision.SyntheticImageDataset(5, (6, 6, 3), 4, seed=3)
    for i in range(5):
        np.testing.assert_array_equal(ts[i][0].asnumpy(), js[i][0].asnumpy())
        assert ts[i][1] == js[i][1]


def test_pinned_staging_reuses_its_blocks(monkeypatch):
    """pin_memory=True stages each host batch bound for the card in a ring
    of page-locked blocks, one ring a batch signature: the copies of 8
    batches make no more blocks than the ring is deep (the page-locked
    allocation and the card are stood in for on the CPU)."""
    from mxnet_tpu_torch.gluon.data import dataloader as dl

    made = []
    real_empty = torch.empty

    def fake_empty(*shape, dtype=None, pin_memory=False):
        made.append(pin_memory)
        return real_empty(*shape, dtype=dtype)

    class FakeEvent:
        def record(self, stream):
            pass

        def synchronize(self):
            pass

    monkeypatch.setattr(dl.torch, "empty", fake_empty)
    monkeypatch.setattr(dl.torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(dl.torch.cuda, "current_stream", lambda dev: None)
    stage = dl._PinnedStage(depth=3)
    for i in range(8):
        out = stage.copy(torch.full((4, 2), float(i)), torch.device("cpu"))
        assert out.eq(i).all()
    assert stage.blocks == 3 and made == [True] * 3
