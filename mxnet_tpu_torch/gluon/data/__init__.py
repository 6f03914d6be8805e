"""Gluon's data API of the PyTorch port (reference: python/mxnet/gluon/
data/; ``mxnet_tpu/gluon/data/``): datasets, samplers, the DataLoader and
``vision`` (transforms and datasets)."""

from . import vision
from .dataloader import DataLoader, default_batchify_fn
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["ArrayDataset", "BatchSampler", "DataLoader", "Dataset",
           "RandomSampler", "RecordFileDataset", "Sampler", "SequentialSampler", "SimpleDataset",
           "default_batchify_fn", "vision"]
