"""Gluon model zoo of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo``)."""

from . import ssd, vision, word_lm

__all__ = ["ssd", "vision", "word_lm"]
