"""Data iterators of the PyTorch port.

Counterpart of ``mxnet_tpu/io/io.py`` (reference: python/mxnet/io/io.py,
src/io/iter_mnist.cc): ``DataDesc``, ``DataBatch``, ``DataIter``,
``ResizeIter``, ``NDArrayIter`` (``last_batch_handle`` ``pad``,
``discard`` or ``roll_over``) and ``MNISTIter``.  Batches are NDArrays on
the host; a Module copies them into its bound arrays on its device.
Without the idx files, ``MNISTIter`` makes the JAX package's deterministic
synthetic digits (the same numpy code), so both packages see the same
data.  ``CSVIter`` reads CSV files into an ``NDArrayIter``
(``round_batch`` pads the last batch); ``PrefetchingIter`` reads one
inner iterator ahead on a background thread.  ``ImageRecordIter`` reads
an image record file into NCHW float32 batches on the current context.
The LibSVM iterator is not ported yet.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import time
import warnings
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..context import cpu, resolve_device
from ..ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter", "NDArrayIter",
           "MNISTIter", "CSVIter", "PrefetchingIter", "ImageRecordIter"]

DataDesc = namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])
DataDesc.__new__.__defaults__ = (np.float32, "NCHW")


class DataBatch:
    """One batch (reference: io.py DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        labels = [l.shape for l in self.label] if self.label else None
        return "%s: data shapes: %s label shapes: %s" % (
            type(self).__name__, [d.shape for d in self.data], labels)


class DataIter:
    """Base iterator (reference: io.py:178)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


class ResizeIter(DataIter):
    """``data_iter`` cut or cycled to ``size`` batches an epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """A data or label argument as ``[(name, numpy array)]``."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    return [(k, np.asarray(v.asnumpy() if isinstance(v, NDArray) else v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (reference: io.py:489).  A last short
    batch is padded by wrapping to the start (``pad``, its ``pad`` the
    count added), dropped (``discard``), or, with ``roll_over``, wrapped
    and the next epoch started where the wrap ended."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.idx = np.arange(self.num_data)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
            self.idx = self.idx[:self.num_data]
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            self.cursor = -self.batch_size + (self.cursor % self.num_data)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, source):
        end = min(self.cursor + self.batch_size, self.num_data)
        sel = self.idx[self.cursor:end]
        if len(sel) < self.batch_size:  # pad by wrapping
            sel = np.concatenate([sel, self.idx[:self.batch_size
                                                - len(sel)]])
        return [array(v[sel], ctx=cpu()) for _, v in source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        return self.idx[self.cursor:min(self.cursor + self.batch_size,
                                        self.num_data)]


def _read_idx_images(path):
    with open(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, "bad MNIST image file"
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(num, rows,
                                                               cols)


def _read_idx_labels(path):
    with open(path, "rb") as f:
        magic, _ = struct.unpack(">II", f.read(8))
        assert magic == 2049, "bad MNIST label file"
        return np.frombuffer(f.read(), dtype=np.uint8)


def _synthetic_mnist(n, seed=0):
    """Deterministic MNIST-like digits, the JAX package's
    (``mxnet_tpu/io/io.py:354-368``): class k lights a distinct 7x7 block
    over uniform noise, so the classes are separable."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    imgs = rng.rand(n, 28, 28).astype(np.float32) * 0.2
    for k in range(10):
        mask = labels == k
        r, c = divmod(k, 4)
        imgs[mask, r * 7:(r + 1) * 7, c * 7:(c + 1) * 7] += 0.8
    return (imgs * 255).astype(np.uint8), labels


class MNISTIter(DataIter):
    """MNIST batches (reference: src/io/iter_mnist.cc:260): the idx files
    at ``image``/``label`` when present, else synthetic digits (6000 for a
    training file name, 1000 otherwise); pixels in [0, 1], ``flat``
    (N, 784) or (N, 1, 28, 28); the last short batch dropped."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False, num_parts=1,
                 part_index=0, **kwargs):
        super().__init__(batch_size)
        del seed, silent, kwargs
        if os.path.exists(image) and os.path.exists(label):
            imgs, labels = _read_idx_images(image), _read_idx_labels(label)
        else:
            train = "train" in str(image)
            imgs, labels = _synthetic_mnist(6000 if train else 1000,
                                            seed=0 if train else 1)
        imgs = imgs.astype(np.float32) / 255.0
        imgs = imgs.reshape(len(imgs), -1) if flat \
            else imgs.reshape(len(imgs), 1, 28, 28)
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            labels = labels[part_index::num_parts]
        self._inner = NDArrayIter(imgs, labels.astype(np.float32),
                                  batch_size=batch_size, shuffle=shuffle,
                                  last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class CSVIter(DataIter):
    """Batches of a CSV file (reference: src/io/iter_csv.cc:218; JAX
    ``io.py:418-455``): rows of ``data_csv`` reshaped to ``data_shape``,
    labels from ``label_csv`` (zeros without one); ``round_batch`` pads
    the last short batch by wrapping to the start, else it is dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        del kwargs
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size, shuffle=False,
            last_batch_handle="pad" if round_batch else "discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


def _renamed(descs, rename):
    if rename is None:
        return descs
    return [DataDesc(rename[0].get(d.name, d.name), d.shape, d.dtype)
            if isinstance(d, DataDesc) else d for d in descs]


class PrefetchingIter(DataIter):
    """One iterator read ahead on a background thread (reference: io.py
    PrefetchingIter over src/io/iter_prefetcher.h; JAX ``io.py:171-246``):
    up to ``capacity`` batches wait in a queue.  ``rename_data`` and
    ``rename_label`` (a list of one dict, old name -> new) rename the
    descriptions."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 capacity=2):
        super().__init__()
        iters = iters if isinstance(iters, list) else [iters]
        assert len(iters) == 1, "PrefetchingIter takes one iterator"
        self.iters = iters
        self.n_iter = 1
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = iters[0].batch_size
        self._queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        return _renamed(self.iters[0].provide_data, self.rename_data)

    @property
    def provide_label(self):
        return _renamed(self.iters[0].provide_label, self.rename_label)

    def _start(self):
        self._stop.clear()

        def worker():
            try:
                for batch in self.iters[0]:
                    if self._stop.is_set():
                        return
                    self._queue.put(batch)
            finally:
                self._queue.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        """Stop the reader, drop what it read, reset the inner iterator
        and read again."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.01)
            except queue.Empty:
                pass
        self._thread.join()
        while not self._queue.empty():
            self._queue.get()
        self.iters[0].reset()
        self._start()

    def next(self):
        batch = self._queue.get()
        if batch is None:
            self._queue.put(None)  # the end stays the end until reset
            raise StopIteration
        return batch

    def iter_next(self):
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _BatchStage:
    """Where an iterator assembles a batch: on the way to the card, a
    page-locked block of a ring a batch signature (``depth`` blocks,
    each reused once its last copy is done: ``gluon.data.dataloader.
    _PinnedStage``), so that a batch crosses with one copy; on the host,
    a new array a batch."""

    def __init__(self, depth=4):
        self._depth = depth
        self._pinned = None

    @property
    def blocks(self):
        """The page-locked blocks made so far."""
        return 0 if self._pinned is None else self._pinned.blocks

    def take(self, shape, dtype, device):
        """``(numpy view to fill, token for send)``."""
        dt = torch.from_numpy(np.zeros(0, dtype)).dtype
        if device.type == "cuda":
            if self._pinned is None:
                from ..gluon.data.dataloader import _PinnedStage

                self._pinned = _PinnedStage(self._depth)
            slot = self._pinned.take(shape, dt)
            return slot[0].numpy(), slot
        t = torch.empty(tuple(shape), dtype=dt)
        return t.numpy(), t

    def send(self, token, device):
        """The filled block as an NDArray on ``device``."""
        if isinstance(token, torch.Tensor):
            return NDArray(token)
        return NDArray(self._pinned.send(token, device))


class ImageRecordIter(DataIter):
    """Batches of an image record file (reference:
    src/io/iter_image_recordio_2.cc; JAX ``io.py:566-748``, its Python
    path): NCHW float32 ``data_shape`` batches and ``(batch,)`` labels
    (``(batch, label_width)`` when wider) on the current context, read
    when the iterator is made.

    The records (:func:`~mxnet_tpu_torch.recordio.pack_img`'s, or with
    ``raw_records`` the raw float32 CHW bytes of each sample) are read
    into memory at construction, the ``part_index``-th of every
    ``num_parts``.  Each batch: the records' headers are read on the
    calling thread, the images decoded by ``preprocess_threads`` host
    threads (cv2, else PIL; a raw record needs no decode), the random
    draws made on the calling thread in sample order from numpy's global
    stream as the JAX package draws them (a crop where the image is
    larger than ``data_shape`` and ``rand_crop``, else a central fit;
    a mirror with ``rand_mirror``), and the samples assembled by the
    threads straight into the batch's block, ``mean_r/g/b`` subtracted;
    raw records take no augmentation and no mean (a warning says so when
    they are given, as the JAX package warns).  Every record of the file
    is held in host memory: a set of ImageNet's size needs the streaming
    reader of ROADMAP Queue 3.  A short last batch is
    filled with records from the epoch's start and says so in ``pad``.
    ``shuffle`` permutes the records at every ``reset`` from numpy's
    global stream, as the JAX package's Python path does;
    ``shuffle_buffer``, ``seed`` and ``use_native`` (the JAX package's
    native pipeline) are accepted and mean nothing here.

    ``host_seconds`` sums the host time of each part (``read``,
    ``decode``, ``assemble``, ``copy``) over ``batches``;
    ``pinned_blocks`` counts the page-locked blocks made."""

    def __init__(self, path_imgrec, data_shape, batch_size=1, label_width=1,
                 shuffle=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 rand_crop=False, rand_mirror=False, num_parts=1,
                 part_index=0, preprocess_threads=4, shuffle_buffer=4096,
                 seed=0, use_native=None, raw_records=False, **kwargs):
        super().__init__(batch_size)
        del shuffle_buffer, seed, use_native, kwargs
        from ..recordio import MXRecordIO

        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = np.array([mean_r, mean_g, mean_b], dtype=np.float32)
        self.shuffle = shuffle
        self._raw_records = raw_records
        if raw_records and (rand_crop or rand_mirror or mean_r or mean_g
                            or mean_b):
            warnings.warn(
                "ImageRecordIter(raw_records=True): augmentation arguments "
                "(rand_crop/rand_mirror/mean_*) are ignored on the raw "
                "memcpy path", stacklevel=2)
        self._device = resolve_device(None)
        self._stage = _BatchStage()
        self._pool = ThreadPoolExecutor(max(1, int(preprocess_threads)))
        self.host_seconds = dict.fromkeys(("read", "decode", "assemble",
                                           "copy"), 0.0)
        self.batches = 0
        rec = MXRecordIO(path_imgrec, "r")
        self._records = []
        while True:
            item = rec.read()
            if item is None:
                break
            self._records.append(item)
        rec.close()
        if num_parts > 1:
            self._records = self._records[part_index::num_parts]
        self._order = np.arange(len(self._records))
        self.cursor = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         np.float32)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape, np.float32)]

    @property
    def pinned_blocks(self):
        return self._stage.blocks

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self._order)
        self.cursor = 0

    def iter_next(self):
        return self.cursor < len(self._records)

    def _draws(self, shape):
        """The JAX package's draws for one image of ``shape`` (HWC):
        ``(crop corner or None, mirror)``."""
        _, h, w = self.data_shape
        corner = None
        if shape[0] != h or shape[1] != w:
            if self.rand_crop and shape[0] >= h and shape[1] >= w:
                y = np.random.randint(0, shape[0] - h + 1)
                x = np.random.randint(0, shape[1] - w + 1)
                corner = (y, x)
        return corner, bool(self.rand_mirror and np.random.rand() < 0.5)

    def _assemble(self, out, img, corner, mirror):
        """One decoded HWC uint8 image into its CHW float32 slot."""
        _, h, w = self.data_shape
        if img.ndim == 2:
            img = img[:, :, None]
        if corner is not None:
            img = img[corner[0]:corner[0] + h, corner[1]:corner[1] + w]
        elif img.shape[0] != h or img.shape[1] != w:
            img = _center_fit(img, h, w)
        if mirror:
            img = img[:, ::-1]
        chw = img.transpose(2, 0, 1)
        if self.mean.any():
            np.subtract(chw, self.mean[:, None, None], out=out,
                        dtype=np.float32)
        else:
            out[...] = chw

    def next(self):
        from ..recordio import decode_payload, unpack

        if not self.iter_next():
            raise StopIteration
        t0 = time.perf_counter()
        n = len(self._records)
        count = min(self.batch_size, n - self.cursor)
        items = [self._records[self._order[(self.cursor + i) % n]]
                 for i in range(self.batch_size)]
        self.cursor += self.batch_size
        data, dtok = self._stage.take((self.batch_size,) + self.data_shape,
                                      np.float32, self._device)
        label, ltok = self._stage.take((self.batch_size, self.label_width),
                                       np.float32, self._device)
        label[:] = 0.0
        payloads = []
        for i, item in enumerate(items):
            # a view: slicing the record's bytes would copy each payload
            header, payload = unpack(memoryview(item))
            lab = np.atleast_1d(np.asarray(header.label, np.float32))
            lab = lab[:self.label_width]
            label[i, :lab.size] = lab
            payloads.append(payload)
        t1 = time.perf_counter()
        if self._raw_records:
            shape = self.data_shape
            list(self._pool.map(
                lambda i: data.__setitem__(i, np.frombuffer(
                    payloads[i], np.float32).reshape(shape)),
                range(self.batch_size)))
            t2 = t3 = time.perf_counter()
        else:
            imgs = list(self._pool.map(decode_payload, payloads))
            t2 = time.perf_counter()
            draws = [self._draws(img.shape) for img in imgs]
            list(self._pool.map(
                lambda i: self._assemble(data[i], imgs[i], *draws[i]),
                range(self.batch_size)))
            t3 = time.perf_counter()
        label_nd = self._stage.send(ltok, self._device)
        if self.label_width == 1:
            label_nd = label_nd.reshape((self.batch_size,))
        batch = DataBatch(data=[self._stage.send(dtok, self._device)],
                          label=[label_nd], pad=self.batch_size - count,
                          provide_data=self.provide_data,
                          provide_label=self.provide_label)
        t4 = time.perf_counter()
        for part, dt in (("read", t1 - t0), ("decode", t2 - t1),
                         ("assemble", t3 - t2), ("copy", t4 - t3)):
            self.host_seconds[part] += dt
        self.batches += 1
        return batch


def _center_fit(img, h, w):
    """``img`` cropped or zero-padded about its centre to ``h`` x ``w``."""
    out = np.zeros((h, w) + img.shape[2:], dtype=img.dtype)
    sy = max((img.shape[0] - h) // 2, 0)
    sx = max((img.shape[1] - w) // 2, 0)
    dy = max((h - img.shape[0]) // 2, 0)
    dx = max((w - img.shape[1]) // 2, 0)
    ch = min(h, img.shape[0])
    cw = min(w, img.shape[1])
    out[dy:dy + ch, dx:dx + cw] = img[sy:sy + ch, sx:sx + cw]
    return out
