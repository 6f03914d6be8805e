"""Datasets of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/data/dataset.py`` (reference:
python/mxnet/gluon/data/dataset.py): ``Dataset`` (``filter``, ``shard``,
``take``, ``transform``, ``transform_first``), ``SimpleDataset``,
``ArrayDataset`` and ``RecordFileDataset`` (the records of an indexed
record file, by position).
"""

from __future__ import annotations

import os

from ... import ndarray, recordio

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Samples by index: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The samples for which ``fn`` holds."""
        return SimpleDataset([i for i in self if fn(i)])

    def shard(self, num_shards, index):
        """Shard ``index`` of ``num_shards`` contiguous ones (the first
        ``len % num_shards`` one longer)."""
        if not 0 <= index < num_shards:
            raise ValueError("shard index %d out of %d" % (index, num_shards))
        length = len(self)
        shard_len, rest = divmod(length, num_shards)
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        """The first ``count`` samples (all of them for None)."""
        if count is None or count > len(self):
            count = len(self)
        return SimpleDataset([self[i] for i in range(count)])

    def transform(self, fn, lazy=True):
        """``fn`` over each sample (a tuple sample is spread over its
        arguments), when read (``lazy``) or now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` over each sample's first element."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A dataset over a list (or anything indexable with a length)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Equal-length arrays zipped: sample ``i`` is the tuple of their
    ``i``-th entries (one array: the entry itself).  A 1-D NDArray is
    read as numpy once, as in the reference, so its entries are scalars."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for data in args:
            if len(data) != self._length:
                raise ValueError("All arrays must have the same length; %d "
                                 "vs %d" % (len(data), self._length))
            if isinstance(data, ndarray.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of ``filename`` and its ``.idx``, as bytes, in the
    index's order."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
