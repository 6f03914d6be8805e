"""Gluon contrib data of the PyTorch port: :class:`IntervalSampler`
(``mxnet_tpu/gluon/contrib/data/``; its WikiText datasets download their
data and are not ported)."""

from .sampler import IntervalSampler

__all__ = ["IntervalSampler"]
