"""Gluon's vision data of the PyTorch port: ``transforms`` and the
datasets."""

from . import transforms
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,
                       ImageFolderDataset, ImageRecordDataset,
                       SyntheticImageDataset)

__all__ = ["CIFAR10", "CIFAR100", "FashionMNIST", "ImageFolderDataset",
           "ImageRecordDataset", "MNIST", "SyntheticImageDataset",
           "transforms"]
