"""Gluon model zoo of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo``)."""

from . import ssd, vision, word_lm
from .vision import get_model

__all__ = ["ssd", "vision", "word_lm", "get_model"]
