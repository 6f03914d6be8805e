"""Vision datasets of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py`` (reference:
python/mxnet/gluon/data/vision/datasets.py): ``MNIST``, ``FashionMNIST``,
``CIFAR10`` and ``CIFAR100`` read files already on disk under ``root``
(the reference's names and formats) and raise, naming the path, when
they are missing: nothing downloads.  ``SyntheticImageDataset`` makes
seeded images.  Samples are host NDArrays (uint8 images, HWC) and int32
labels.  ``ImageRecordDataset`` decodes an image record file's records,
``ImageFolderDataset`` a folder of class folders (cv2, else PIL).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from .... import ndarray, recordio
from ....context import cpu
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "SyntheticImageDataset"]


class _DownloadedDataset(Dataset):
    """Images (N, H, W, C) uint8 and labels, read by ``_get_data``."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        img = ndarray.array(self._data[idx], ctx=cpu(), dtype="uint8")
        if self._transform is not None:
            return self._transform(img, self._label[idx])
        return img, self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from its idx-gz files under ``root``."""

    _train_files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        image_file, label_file = self._train_files if self._train \
            else self._test_files
        image_path = os.path.join(self._root, image_file)
        label_path = os.path.join(self._root, label_file)
        for path in (image_path, label_path):
            if not os.path.exists(path):
                raise RuntimeError(
                    "%s not found: place the dataset's files there (nothing "
                    "is downloaded), or use SyntheticImageDataset" % path)
        with gzip.open(label_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
        with gzip.open(image_path, "rb") as f:
            _, _, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        self._label = label
        self._data = data.reshape(len(label), rows, cols, 1)


class FashionMNIST(MNIST):
    """Fashion-MNIST, in MNIST's file format."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from its python batches under ``root`` (the folder or the
    tarball)."""

    _archive = "cifar-10-python.tar.gz"
    _folder = "cifar-10-batches-py"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, fobj):
        d = pickle.load(fobj, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = d.get(b"labels", d.get(b"fine_labels"))
        return data, np.asarray(labels, dtype=np.int32)

    def _batches(self):
        if self._train:
            return ["data_batch_%d" % i for i in range(1, 6)]
        return ["test_batch"]

    def _get_data(self):
        folder = os.path.join(self._root, self._folder)
        archive = os.path.join(self._root, self._archive)
        datas, labels = [], []
        if os.path.isdir(folder):
            for b in self._batches():
                with open(os.path.join(folder, b), "rb") as f:
                    d, lab = self._read_batch(f)
                datas.append(d)
                labels.append(lab)
        elif os.path.exists(archive):
            with tarfile.open(archive) as tf:
                for b in self._batches():
                    d, lab = self._read_batch(
                        tf.extractfile("%s/%s" % (self._folder, b)))
                    datas.append(d)
                    labels.append(lab)
        else:
            raise RuntimeError(
                "%s not found (nor the folder %s): place the dataset there "
                "(nothing is downloaded), or use SyntheticImageDataset"
                % (archive, folder))
        self._data = np.concatenate(datas)
        self._label = np.concatenate(labels)


class CIFAR100(CIFAR10):
    """CIFAR-100, fine labels unless ``fine_label=False``."""

    _archive = "cifar-100-python.tar.gz"
    _folder = "cifar-100-python"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _batches(self):
        return ["train"] if self._train else ["test"]

    def _read_batch(self, fobj):
        d = pickle.load(fobj, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = b"fine_labels" if self._fine else b"coarse_labels"
        return data, np.asarray(d[key], dtype=np.int32)


class SyntheticImageDataset(Dataset):
    """``length`` seeded uint8 images of ``shape`` and int32 labels below
    ``num_classes``, for tests and benchmarks (the JAX package's
    addition)."""

    def __init__(self, length=1024, shape=(32, 32, 3), num_classes=10,
                 transform=None, seed=0):
        self._length = length
        rng = np.random.RandomState(seed)
        self._images = rng.randint(0, 256, size=(length,) + tuple(shape),
                                   dtype=np.uint8)
        self._labels = rng.randint(0, num_classes,
                                   size=(length,)).astype(np.int32)
        self._transform = transform

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        img = ndarray.array(self._images[idx], ctx=cpu(), dtype="uint8")
        label = self._labels[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageRecordDataset(RecordFileDataset):
    """``(image, label)`` of each record of an image record file: the
    image decoded to an HWC uint8 NDArray on the host (``flag`` 0: one
    gray channel), then ``transform(image, label)`` if given."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image

        header, img_bytes = recordio.unpack(super().__getitem__(idx))
        img = image.imdecode(img_bytes, flag=self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """``(image, label)`` of the ``.jpg``, ``.jpeg`` and ``.png`` files
    under ``root``'s sub-folders, one class a folder in name order
    (``synsets``), the files of each in name order (``items``)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image

        with open(self.items[idx][0], "rb") as f:
            img = image.imdecode(f.read(), flag=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
