"""``LSTMPCell`` and ``VariationalDropoutCell`` (reference:
python/mxnet/gluon/contrib/rnn/rnn_cell.py;
``mxnet_tpu/gluon/contrib/rnn/__init__.py:20`` and ``rnn_cell.py:12``)."""

from __future__ import annotations

from ...block import BoundOp
from ...rnn.rnn_cell import HybridRecurrentCell, _ModifierCell

__all__ = ["LSTMPCell", "VariationalDropoutCell"]

_SIGMOID = BoundOp("sigmoid")
_TANH = BoundOp("tanh")
_ONES_LIKE = BoundOp("ones_like")


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projection of the hidden state (LSTMP): states ``[r,
    c]``, ``r = h2r_weight @ h`` of ``projection_size``."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        rows = 4 * hidden_size
        self._fc = BoundOp("FullyConnected", num_hidden=rows)
        self._split = BoundOp("SliceChannel", num_outputs=4, axis=1)
        self._project = BoundOp("FullyConnected", no_bias=True,
                                num_hidden=projection_size)
        self._param("i2h_weight", (rows, input_size),
                    init=i2h_weight_initializer)
        self._param("h2h_weight", (rows, projection_size),
                    init=h2h_weight_initializer)
        self._param("h2r_weight", (projection_size, hidden_size),
                    init=h2r_weight_initializer)
        self._param("i2h_bias", (rows,), init=i2h_bias_initializer)
        self._param("h2h_bias", (rows,), init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        gates = self._fc(F, inputs, i2h_weight, i2h_bias) \
            + self._fc(F, states[0], h2h_weight, h2h_bias)
        i, f, g, o = self._split(F, gates)
        i, f, g, o = (_SIGMOID(F, i), _SIGMOID(F, f), _TANH(F, g),
                      _SIGMOID(F, o))
        next_c = f * states[1] + i * g
        next_r = self._project(F, o * _TANH(F, next_c), h2r_weight)
        return next_r, [next_r, next_c]


class VariationalDropoutCell(_ModifierCell):
    """Dropout of one mask across time (Gal and Ghahramani 2016) on the
    base cell's inputs, first state and outputs: each mask is drawn at the
    first step after :meth:`reset` and kept for the rest of the
    sequence (train mode; the identity in predict mode)."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._drops = {name: BoundOp("Dropout", p=p) for name, p in (
            ("inputs", drop_inputs), ("states", drop_states),
            ("outputs", drop_outputs)) if p}
        self.reset()

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _mask(self, F, name, like):
        return self._drops[name](F, _ONES_LIKE(F, like))

    def hybrid_forward(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = self._mask(F, "states", states[0])
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = self._mask(F, "inputs", inputs)
        if self.drop_states:
            # h is the first state of every base cell
            states = [states[0] * self.drop_states_mask] + list(states[1:])
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = self.base_cell(inputs, states)
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = self._mask(F, "outputs", next_output)
        if self.drop_outputs:
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states

    def __repr__(self):
        return "VariationalDropoutCell(%s)" % self.base_cell.name
