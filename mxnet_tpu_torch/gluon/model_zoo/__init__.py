"""Gluon model zoo of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo``)."""

from . import vision, word_lm

__all__ = ["vision", "word_lm"]
