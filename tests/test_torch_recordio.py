"""The port's RecordIO (mxnet_tpu_torch/recordio.py), its record datasets
and its im2rec against the JAX package's, on the CPU.

Every comparison is exact: record and ``.idx`` files byte for byte in
both directions, headers and labels equal, and decoded pixels equal
(both packages' records go through PIL, their ``imdecode`` through cv2
where it imports, else PIL).
"""

import importlib.util
import os
import struct

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon.data import RecordFileDataset as JRecordFileDataset
from mxnet_tpu.gluon.data.vision import datasets as jdatasets
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, recordio as trec
from mxnet_tpu_torch.gluon.data import RecordFileDataset
from mxnet_tpu_torch.gluon.data.vision import (ImageFolderDataset,
                                               ImageRecordDataset)
from mxnet_tpu_torch.tools import im2rec as tim2rec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(seed=0, n=7):
    """Payloads of every length modulo 4, with scalar and vector labels."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        payload = rs.randint(0, 256, size=13 + i, dtype=np.uint8).tobytes()
        label = float(i) if i % 2 else rs.rand(i + 1).astype(np.float32)
        out.append((jrec.IRHeader(0, label, i, 100 + i), payload))
    return out


def _write(pkg, path, records, indexed):
    if indexed:
        w = pkg.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
        for hdr, payload in records:
            w.write_idx(hdr.id, pkg.pack(hdr, payload))
    else:
        w = pkg.MXRecordIO(path + ".rec", "w")
        for hdr, payload in records:
            w.write(pkg.pack(hdr, payload))
    w.close()


def _read_all(pkg, path):
    r = pkg.MXRecordIO(path + ".rec", "r")
    out = []
    while True:
        item = r.read()
        if item is None:
            break
        out.append(pkg.unpack(item))
    r.close()
    return out


def _same_header(a, b):
    assert (a.flag, a.id, a.id2) == (b.flag, b.id, b.id2)
    np.testing.assert_array_equal(np.asarray(a.label), np.asarray(b.label))


@pytest.mark.parametrize("indexed", [False, True], ids=["plain", "indexed"])
def test_files_are_byte_identical_and_cross_both_ways(tmp_path, indexed):
    records = _records()
    _write(trec, str(tmp_path / "port"), records, indexed)
    _write(jrec, str(tmp_path / "jax"), records, indexed)
    for ext in (".rec", ".idx") if indexed else (".rec",):
        with open(tmp_path / ("port" + ext), "rb") as f, \
                open(tmp_path / ("jax" + ext), "rb") as g:
            assert f.read() == g.read()
    for writer, reader in (("port", jrec), ("jax", trec)):
        got = _read_all(reader, str(tmp_path / writer))
        assert len(got) == len(records)
        for (hdr, payload), (want_hdr, want_payload) in zip(got, records):
            assert payload == want_payload
            assert hdr.id == want_hdr.id and hdr.id2 == want_hdr.id2
            np.testing.assert_array_equal(np.asarray(hdr.label, np.float32),
                                          np.asarray(want_hdr.label,
                                                     np.float32))


def test_indexed_reads_by_key_and_keys_in_order(tmp_path):
    records = _records(n=5)
    _write(jrec, str(tmp_path / "j"), records, True)
    p = str(tmp_path / "j")
    mine = trec.MXIndexedRecordIO(p + ".idx", p + ".rec", "r")
    theirs = jrec.MXIndexedRecordIO(p + ".idx", p + ".rec", "r")
    assert mine.keys == theirs.keys == [0, 1, 2, 3, 4]
    for k in reversed(mine.keys):
        assert mine.read_idx(k) == theirs.read_idx(k)
    mine.reset()
    assert mine.read() == theirs.read_idx(0)


def test_truncated_files_raise(tmp_path):
    p = str(tmp_path / "t")
    _write(trec, p, _records(n=2), False)
    with open(p + ".rec", "rb") as f:
        data = f.read()
    for cut, what in ((len(data) - 5, "payload"), (4, "header")):
        with open(p + ".rec", "wb") as f:
            f.write(data[:cut])
        r = trec.MXRecordIO(p + ".rec", "r")
        with pytest.raises(IOError, match="truncated"):
            while r.read() is not None:
                pass
    with open(p + ".rec", "wb") as f:
        f.write(struct.pack("<II", 1234, 0))
    with pytest.raises(IOError, match="magic"):
        trec.MXRecordIO(p + ".rec", "r").read()


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_is_the_jax_packages_bytes(fmt):
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, size=(20, 17, 3), dtype=np.uint8)
    hdr = jrec.IRHeader(0, 4.0, 9, 0)
    got = trec.pack_img(hdr, img, quality=90, img_fmt=fmt)
    assert got == jrec.pack_img(hdr, img, quality=90, img_fmt=fmt)
    (h1, a1), (h2, a2) = trec.unpack_img(got), jrec.unpack_img(got)
    _same_header(h1, h2)
    np.testing.assert_array_equal(a1, a2)
    if fmt == ".png":
        np.testing.assert_array_equal(a1, img)


def test_the_jax_packages_raw_records_decode():
    img = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
    meta = struct.pack("<III", 4, 5, 3)
    rec = jrec.pack(jrec.IRHeader(0, 1.0, 0, 0), b"RAW0" + meta
                    + img.tobytes())
    np.testing.assert_array_equal(trec.unpack_img(rec)[1], img)
    np.testing.assert_array_equal(jrec.unpack_img(rec)[1], img)


def test_no_codec_raises_naming_both(monkeypatch):
    monkeypatch.setattr(trec, "codec", lambda order=None: None)
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(MXNetError, match="cv2.*PIL"):
        trec.pack_img(jrec.IRHeader(0, 0.0, 0, 0), img)
    rec = jrec.pack_img(jrec.IRHeader(0, 0.0, 0, 0), img)
    with pytest.raises(MXNetError, match="neither cv2"):
        trec.unpack_img(rec)
    from mxnet_tpu_torch import image

    with pytest.raises(MXNetError, match="neither cv2"):
        image.imdecode(trec.unpack(rec)[1])


def _image_rec(tmp_path, n=6, hw=(12, 10)):
    rs = np.random.RandomState(5)
    p = str(tmp_path / "img")
    w = jrec.MXIndexedRecordIO(p + ".idx", p + ".rec", "w")
    imgs = []
    for i in range(n):
        img = rs.randint(0, 256, size=hw + (3,), dtype=np.uint8)
        label = float(i % 3) if i % 2 else np.array([i, 2 * i], np.float32)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, label, i, 0), img,
                                     img_fmt=".png"))
        imgs.append(img)
    w.close()
    return p, imgs


def test_record_datasets_match_the_jax_packages(tmp_path):
    p, imgs = _image_rec(tmp_path)
    raw, jraw = RecordFileDataset(p + ".rec"), JRecordFileDataset(p + ".rec")
    assert len(raw) == len(jraw) == len(imgs)
    assert [raw[i] for i in range(len(raw))] == \
        [jraw[i] for i in range(len(jraw))]
    ds = ImageRecordDataset(p + ".rec")
    jds = jdatasets.ImageRecordDataset(p + ".rec")
    gray = ImageRecordDataset(p + ".rec", flag=0)
    jgray = jdatasets.ImageRecordDataset(p + ".rec", flag=0)
    for i in range(len(ds)):
        (img, label), (jimg, jlabel) = ds[i], jds[i]
        assert img.context == tmx.cpu()
        np.testing.assert_array_equal(img.asnumpy(), jimg.asnumpy())
        np.testing.assert_array_equal(img.asnumpy(), imgs[i])
        np.testing.assert_array_equal(np.asarray(label), np.asarray(jlabel))
        np.testing.assert_array_equal(gray[i][0].asnumpy(),
                                      jgray[i][0].asnumpy())
    doubled = ImageRecordDataset(p + ".rec",
                                 transform=lambda x, y: (x, y * 2))
    np.testing.assert_array_equal(np.asarray(doubled[1][1]),
                                  2 * np.asarray(ds[1][1]))


def _folder(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(8)
    root = tmp_path / "folder"
    for cls in ("b_dogs", "a_cats"):
        os.makedirs(root / cls)
        for j in range(3):
            Image.fromarray(rs.randint(0, 256, (9, 11, 3), np.uint8)).save(
                str(root / cls / ("%d.png" % j)))
    (root / "notes.txt").write_text("not a class")
    (root / "a_cats" / "skip.txt").write_text("not an image")
    return str(root)


def test_image_folder_dataset_matches_the_jax_packages(tmp_path):
    root = _folder(tmp_path)
    ds, jds = ImageFolderDataset(root), jdatasets.ImageFolderDataset(root)
    assert ds.synsets == jds.synsets == ["a_cats", "b_dogs"]
    assert ds.items == jds.items and len(ds) == 6
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i][0].asnumpy(),
                                      jds[i][0].asnumpy())
        assert ds[i][1] == jds[i][1]


def _jax_im2rec():
    spec = importlib.util.spec_from_file_location(
        "jax_im2rec_tool", os.path.join(REPO, "tools", "im2rec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [[], ["--shuffle", "0"],
                                  ["--train-ratio", "0.5"]],
                         ids=["shuffled", "in-order", "split"])
def test_im2rec_writes_the_jax_tools_files(tmp_path, args):
    root = _folder(tmp_path)
    files = {}
    for name, tool in (("port", tim2rec), ("jax", _jax_im2rec())):
        prefix = str(tmp_path / name)
        tool.main([prefix, root, "--list"] + args)
        lsts = sorted(f for f in os.listdir(tmp_path)
                      if f.startswith(name) and f.endswith(".lst"))
        for lst in lsts:
            tool.main([str(tmp_path / lst[:-4]), root])
        files[name] = {f[len(name):]: open(tmp_path / f, "rb").read()
                       for f in os.listdir(tmp_path) if f.startswith(name)}
    assert set(files["port"]) == set(files["jax"])
    assert len(files["port"]) == (6 if args == ["--train-ratio", "0.5"]
                                  else 3)
    for suffix, data in files["port"].items():
        assert data == files["jax"][suffix], suffix
