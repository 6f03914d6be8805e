"""Fused multi-layer RNN, LSTM and GRU layers of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference:
python/mxnet/gluon/rnn/rnn_layer.py ``_RNNLayer``).  The parameters are
``l0_i2h_weight``, ``l0_h2h_weight``, ``l0_i2h_bias``, ``l0_h2h_bias``,
then ``r0_...`` for the reverse direction, then layer 1 and on: the JAX
package's structural names, in its order.  The JAX layer packs them into
the flat vector of the registered ``RNN`` op on every forward; this one
hands the per-layer tensors to the op's core,
:func:`~mxnet_tpu_torch.ops.rnn.rnn_forward`, directly.
"""

from __future__ import annotations

import torch

from ... import autograd as _autograd
from ...ops import rnn as _rnn
from ..block import HybridBlock, is_deferred

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """The shared layer: ``hidden_size`` units, ``num_layers`` layers,
    ``layout`` "TNC" or "NTC", dropout between layers, and
    ``input_size=0`` to take the input width from the first input."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, *, device=None):
        super().__init__(device=device)
        if layout not in ("TNC", "NTC"):
            raise ValueError("layout must be 'TNC' or 'NTC', not %r"
                             % (layout,))
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._gates = _rnn.GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        self._names = []
        for i in range(num_layers):
            for j in "lr"[:self._dir]:
                names = ["%s%d_%s" % (j, i, n) for n in
                         ("i2h_weight", "h2h_weight", "i2h_bias",
                          "h2h_bias")]
                self._param(names[0], (ng * nh, ni),
                            init=i2h_weight_initializer)
                self._param(names[1], (ng * nh, nh),
                            init=h2h_weight_initializer)
                self._param(names[2], (ng * nh,), init=i2h_bias_initializer)
                self._param(names[3], (ng * nh,), init=h2h_bias_initializer)
                self._names.append(names)
            ni = nh * self._dir

    def __repr__(self):
        return "%s(%s, %s layers, hidden=%s%s)" % (
            type(self).__name__, self._layout, self._num_layers,
            self._hidden_size, ", bidirectional" if self._dir == 2 else "")

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"}
                for _ in range(2 if self._mode == "lstm" else 1)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, each made by ``func(shape, **kwargs)``
        (default ``torch.zeros`` on the layer's device)."""
        if func is None:
            func = torch.zeros
            kwargs.setdefault("device", self.device)
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None):
        if isinstance(states, torch.Tensor):
            states = [states]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(inputs.shape[self._layout.find("N")],
                                      device=inputs.device,
                                      dtype=inputs.dtype)
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        first = self._names[0][0]
        if is_deferred(getattr(self, first)):
            for j in range(self._dir):
                self._finish_deferred(**{self._names[j][0]: (
                    self._gates * self._hidden_size, inputs.shape[2])})
        weights = [[getattr(self, n) for n in names] for names in self._names]
        out, h, c = _rnn.rnn_forward(
            inputs, weights, states[0], states[1] if len(states) > 1
            else None, mode=self._mode, num_layers=self._num_layers,
            bidirectional=self._dir == 2, p=self._dropout,
            training=_autograd.is_training())
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, ([h, c] if self._mode == "lstm" else [h])


class RNN(_RNNLayer):
    """Multi-layer Elman RNN, ``activation`` "relu" or "tanh"
    (reference: rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 *, device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation,
                         device=device)


class LSTM(_RNNLayer):
    """Multi-layer LSTM, cuDNN's gate order (i, f, g, o) (reference:
    rnn_layer.py LSTM).  States: ``[h, c]``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 *, device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", device=device)


class GRU(_RNNLayer):
    """Multi-layer GRU, cuDNN's gate order (r, z, n) (reference:
    rnn_layer.py GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 *, device=None):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", device=device)
