"""Gluon contrib of the PyTorch port (reference:
python/mxnet/gluon/contrib/; ``mxnet_tpu/gluon/contrib/``): ``nn``,
``rnn`` and ``data.IntervalSampler``.

Not ported: ``nn.SparseEmbedding`` (row-sparse gradients),
``data.text`` (WikiText, which downloads its data) and ``parallel``
(``PipelineBlock``, ``MoE``)."""

from . import data, nn, rnn

__all__ = ["data", "nn", "rnn"]
