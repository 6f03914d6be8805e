"""Basic layers of the PyTorch port.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py`` HybridSequential,
Dense, Dropout, LayerNorm and Embedding, with the same parameter names
and layouts.  The JAX package infers an input width on the first call
(deferred init); the port takes it at construction (``in_units``,
``in_channels``).
"""

from __future__ import annotations

from ... import autograd as _autograd
from ...ops import matrix as _matrix
from ...ops import nn as _ops
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "Dropout", "LayerNorm", "Embedding"]


def _width(value, what):
    if value <= 0:
        raise ValueError("%s must be given: the port has no deferred "
                         "shape inference" % what)
    return value


class HybridSequential(HybridBlock):
    """Blocks run in order; children are named ``0``, ``1``, ..."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """``x @ weight.T + bias``, weight (units, in_units)."""

    def __init__(self, units, use_bias=True, flatten=True, in_units=0,
                 device=None):
        super().__init__(device=device)
        self._flatten = flatten
        self._param("weight", (units, _width(in_units, "in_units")))
        if use_bias:
            self._param("bias", (units,))
        else:
            self.bias = None

    def forward(self, x):
        return _ops.fully_connected(x, self.weight, self.bias,
                                    flatten=self._flatten)


class Dropout(HybridBlock):
    """Dropout of rate ``rate``: drops only in train mode
    (:func:`~mxnet_tpu_torch.autograd.is_training`, on under
    ``autograd.record()``), the identity otherwise."""

    def __init__(self, rate, device=None):
        super().__init__(device=device)
        self._rate = rate

    def forward(self, x):
        return _ops.dropout(x, p=self._rate, training=_autograd.is_training())


class LayerNorm(HybridBlock):
    """Layer normalization over the last axis with ``gamma`` and ``beta``."""

    def __init__(self, epsilon=1e-5, in_channels=0, device=None):
        super().__init__(device=device)
        self._epsilon = epsilon
        c = _width(in_channels, "in_channels")
        self._param("gamma", (c,))
        self._param("beta", (c,))

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, eps=self._epsilon)


class Embedding(HybridBlock):
    """Id -> row of ``weight`` (input_dim, output_dim), with the JAX
    package's index semantics (:func:`~mxnet_tpu_torch.ops.matrix.embedding`)."""

    def __init__(self, input_dim, output_dim, device=None):
        super().__init__(device=device)
        self._param("weight", (input_dim, output_dim))

    def forward(self, x):
        return _matrix.embedding(x, self.weight)
