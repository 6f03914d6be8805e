"""The port's ``mx.io.ImageRecordIter`` against the JAX package's Python
path (``use_native=False``), on the CPU, and a small convolutional net
trained by ``Module.fit`` over it through ``mx.kv.create("local")``.

Batches are compared exactly: both packages read the same records,
decode the JPEGs through PIL, draw the crops and mirrors from numpy's
global stream in the same order (seeded alike) and subtract the mean in
float32.  The JAX package's shuffle draws a permutation from that stream
at ``reset``: with ``shuffle=False`` the batches are held equal, with
``shuffle=True`` the law (each record once an epoch, the shards
disjoint).

The trained nets' parameters after 3 batches: within 1e-5 of their
largest magnitude of the JAX Module's (float32 convolutions summed in
another order in each package), and bitwise equal on the port between
a store object (updates on the store) and ``kvstore="local"`` (no
store).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError

SHAPE = (3, 32, 32)


def _write_jpeg(path, n=20, hw=(36, 40), classes=4, seed=0):
    rs = np.random.RandomState(seed)
    w = jrec.MXRecordIO(path, "w")
    for i in range(n):
        img = (rs.rand(*hw, 3) * 80).astype(np.uint8)
        lab = i % classes
        img[lab * 8:(lab + 1) * 8] += 120
        w.write(jrec.pack_img(jrec.IRHeader(0, float(lab), i, 0), img))
    w.close()
    return path


def _write_raw(path, n=13, seed=1, label_width=1):
    rs = np.random.RandomState(seed)
    w = jrec.MXRecordIO(path, "w")
    for i in range(n):
        x = rs.normal(size=SHAPE).astype(np.float32)
        lab = float(i % 3) if label_width == 1 else \
            np.arange(label_width, dtype=np.float32) + i
        w.write(jrec.pack(jrec.IRHeader(0, lab, i, 0), x.tobytes()))
    w.close()
    return path


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out


def _both(path, seed=3, **kwargs):
    """Two epochs of both packages' iterators, numpy's global stream
    seeded alike before each."""
    with tmx.cpu():
        np.random.seed(seed)
        got = _epochs(tmx.io.ImageRecordIter(path, SHAPE, **kwargs))
    np.random.seed(seed)
    want = _epochs(jmx.io.ImageRecordIter(path, SHAPE, use_native=False,
                                          **kwargs))
    return got, want


@pytest.mark.parametrize("kwargs", [
    {"batch_size": 6},
    {"batch_size": 6, "mean_r": 123.68, "mean_g": 116.779,
     "mean_b": 103.939},
    {"batch_size": 4, "rand_crop": True, "rand_mirror": True,
     "mean_r": 10.0, "mean_g": 20.0, "mean_b": 30.0,
     "preprocess_threads": 3},
    {"batch_size": 4, "num_parts": 3, "part_index": 2, "rand_mirror": True},
], ids=["plain", "mean", "crop-mirror-threads", "sharded"])
def test_jpeg_batches_equal_the_jax_packages(tmp_path, kwargs):
    path = _write_jpeg(str(tmp_path / "j.rec"))
    got, want = _both(path, **kwargs)
    assert len(got) == len(want) > 2
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.dtype == np.float32 and gd.shape == wd.shape
        assert gp == wp
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    records = len(range(kwargs.get("part_index", 0), 20,
                        kwargs.get("num_parts", 1)))
    assert any(p > 0 for _, _, p in got) == \
        (records % kwargs["batch_size"] != 0)


@pytest.mark.parametrize("label_width", [1, 3])
def test_raw_batches_equal_the_jax_packages(tmp_path, label_width):
    path = _write_raw(str(tmp_path / "r.rec"), label_width=label_width)
    got, want = _both(path, batch_size=5, raw_records=True,
                      label_width=label_width)
    assert len(got) == len(want) == 6
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl.reshape(wl.shape), wl)
        assert gl.shape == ((5,) if label_width == 1 else (5, label_width))
    assert got[2][2] == 2  # 13 records: the third batch wraps 2


@pytest.mark.parametrize("kwargs", [{"rand_mirror": True},
                                    {"rand_crop": True}, {"mean_g": 1.0}])
def test_raw_records_warn_that_augmentation_is_ignored(tmp_path, kwargs):
    """Both packages warn, and their batches stay the raw records."""
    path = _write_raw(str(tmp_path / "r.rec"), n=4)
    with tmx.cpu(), pytest.warns(UserWarning, match="ignored on the raw"):
        tmx.io.ImageRecordIter(path, SHAPE, batch_size=2, raw_records=True,
                               **kwargs)
    with pytest.warns(UserWarning, match="ignored on the raw"):
        got, want = _both(path, batch_size=2, raw_records=True, **kwargs)
    for (gd, _, _), (wd, _, _) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)


def test_batches_are_the_records_minus_the_mean(tmp_path):
    path = _write_jpeg(str(tmp_path / "j.rec"), hw=SHAPE[1:], n=7)
    mean = np.array([5.0, 6.0, 7.0], np.float32)
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(path, SHAPE, batch_size=4,
                                    mean_r=5.0, mean_g=6.0, mean_b=7.0)
        batches = list(it)
    r = tmx.recordio.MXRecordIO(path, "r")
    recs = [tmx.recordio.unpack_img(r.read()) for _ in range(7)]
    for k, b in enumerate(batches):
        for i in range(4):
            hdr, img = recs[(4 * k + i) % 7]
            want = (img.astype(np.float32) - mean).transpose(2, 0, 1)
            np.testing.assert_array_equal(b.data[0].asnumpy()[i], want)
            assert b.label[0].asnumpy()[i] == hdr.label
    assert [b.pad for b in batches] == [0, 1]
    assert it.batches == 2 and it.pinned_blocks == 0
    assert set(it.host_seconds) == {"read", "decode", "assemble", "copy"}


def test_shuffle_law_and_disjoint_shards(tmp_path):
    path = _write_raw(str(tmp_path / "r.rec"), n=24)
    ids = []
    with tmx.cpu():
        for part in range(3):
            it = tmx.io.ImageRecordIter(path, SHAPE, batch_size=4,
                                        shuffle=True, raw_records=True,
                                        num_parts=3, part_index=part)
            epochs = []
            for _ in range(3):
                seen = []
                for b in it:
                    # each record's first value identifies it
                    seen += [float(v) for v in b.data[0].asnumpy()[:, 0, 0, 0]]
                it.reset()
                epochs.append(seen)
            assert all(sorted(e) == sorted(epochs[0]) and len(set(e)) == 8
                       for e in epochs)
            assert epochs[0] != epochs[1] or epochs[1] != epochs[2]
            ids.append(set(epochs[0]))
    assert not (ids[0] & ids[1] or ids[0] & ids[2] or ids[1] & ids[2])
    assert len(ids[0] | ids[1] | ids[2]) == 24


def test_descriptions_and_the_device(tmp_path, monkeypatch):
    path = _write_raw(str(tmp_path / "r.rec"), n=4)
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(path, SHAPE, batch_size=2, label_width=2,
                                    raw_records=True, use_native=True,
                                    seed=7, shuffle_buffer=16)
        b = next(iter(it))
    assert it.provide_data[0].name == "data"
    assert it.provide_data[0].shape == (2,) + SHAPE
    assert it.provide_label[0].shape == (2, 2)
    assert b.data[0].context == tmx.cpu()
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        tmx.io.ImageRecordIter(path, SHAPE, batch_size=2, raw_records=True)


# ------------------------------------------------------------ Module.fit


def _conv_net(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                              name="conv1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                          name="pool1")
    net = pkg.sym.FullyConnected(pkg.sym.Flatten(net), num_hidden=4,
                                 name="fc")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _fit(pkg, path, kvstore, params):
    it = pkg.io.ImageRecordIter(path, SHAPE, batch_size=8,
                                mean_r=100.0, mean_g=100.0, mean_b=100.0,
                                **({} if pkg is tmx else
                                   {"use_native": False}))
    it = pkg.io.ResizeIter(it, 3)
    with pkg.name.NameManager() if pkg is tmx else \
            jmx.base.NameManager():
        sym = _conv_net(pkg)
    ctx = pkg.cpu()
    mod = pkg.mod.Module(sym, context=ctx)
    opt = pkg.optimizer.SGD(learning_rate=0.05, momentum=0.9, wd=1e-4,
                            rescale_grad=1.0 / 8)
    if pkg is jmx:
        opt.set_wd_mult({})
    mod.fit(it, num_epoch=1, optimizer=opt,
            arg_params={k: pkg.nd.array(v, ctx=ctx)
                        for k, v in params.items()},
            kvstore=kvstore(pkg) if callable(kvstore) else kvstore,
            eval_metric="acc")
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, mod


def test_module_fit_through_a_store_matches_jax_and_local(tmp_path):
    path = _write_jpeg(str(tmp_path / "j.rec"), n=24, hw=SHAPE[1:])
    rs = np.random.RandomState(0)
    params = {"conv1_weight": rs.normal(0, 0.1, (8, 3, 3, 3)),
              "conv1_bias": np.zeros(8), "fc_weight":
              rs.normal(0, 0.01, (4, 8 * 16 * 16)), "fc_bias": np.zeros(4)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    with tmx.cpu():
        got, mod = _fit(tmx, path, lambda p: p.kv.create("local"), params)
        local, _ = _fit(tmx, path, "local", params)
    assert mod._update_on_kvstore and mod._kvstore.type == "local"
    want, jmod = _fit(jmx, path, lambda p: p.kv.create("local"), params)
    assert jmod._update_on_kvstore
    for k, v in want.items():
        assert not np.array_equal(v, params[k]) or k.endswith("bias")
        np.testing.assert_array_equal(got[k], local[k], err_msg=k)
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)
