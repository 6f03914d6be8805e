"""Gluon model zoo of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo``)."""

from . import vision

__all__ = ["vision"]
