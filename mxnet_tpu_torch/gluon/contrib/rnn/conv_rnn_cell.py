"""Convolutional recurrent cells (reference:
python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py;
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``):
``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``, whose input-to-hidden and
hidden-to-hidden transforms are ``Convolution`` nodes over channel-first
data (``NCW``, ``NCHW``, ``NCDHW``) with OI(D)HW weights.  The h2h
convolution keeps the state's spatial shape (an odd kernel, stride 1, pad
``dilate * (k - 1) // 2``).  On the card a 1-D or 2-D cell's weight
gradients are the convolution's K1 kernels."""

from __future__ import annotations

from ...block import BoundOp
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(val, n, name):
    if isinstance(val, int):
        return (val,) * n
    val = tuple(val)
    if len(val) != n:
        raise ValueError("%s must have %d elements, not %s" % (name, n, val))
    return val


class _BaseConvRNNCell(HybridRecurrentCell):
    """The i2h and h2h convolutions' parameters and the state's shape."""

    _gates = 1
    _n_states = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        if not conv_layout.startswith("NC"):
            raise ValueError("only channel-first layouts (NCW/NCHW/NCDHW) "
                             "are supported, got %r" % (conv_layout,))
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)  # (C, *spatial)
        self._conv_layout = conv_layout
        self._activation = activation
        self._dims = dims
        i2h_kernel = _tup(i2h_kernel, dims, "i2h_kernel")
        h2h_kernel = _tup(h2h_kernel, dims, "h2h_kernel")
        if any(k % 2 == 0 for k in h2h_kernel):
            raise ValueError("h2h_kernel must be odd to keep the state's "
                             "shape, got %s" % (h2h_kernel,))
        i2h_pad = _tup(i2h_pad, dims, "i2h_pad")
        i2h_dilate = _tup(i2h_dilate, dims, "i2h_dilate")
        h2h_dilate = _tup(h2h_dilate, dims, "h2h_dilate")
        h2h_pad = tuple(d * (k - 1) // 2 for d, k in zip(h2h_dilate,
                                                         h2h_kernel))
        self._state_shape = (hidden_channels,) + tuple(
            s + 2 * p - d * (k - 1) for s, p, d, k in zip(
                self._input_shape[1:], i2h_pad, i2h_dilate, i2h_kernel))
        rows = self._gates * hidden_channels
        self._i2h = BoundOp("Convolution", kernel=i2h_kernel,
                            stride=(1,) * dims, pad=i2h_pad,
                            dilate=i2h_dilate, num_filter=rows)
        self._h2h = BoundOp("Convolution", kernel=h2h_kernel,
                            stride=(1,) * dims, pad=h2h_pad,
                            dilate=h2h_dilate, num_filter=rows)
        self._act = BoundOp("Activation", act_type=activation)
        self._sigmoid = BoundOp("Activation", act_type="sigmoid")
        self._split = BoundOp("SliceChannel", num_outputs=self._gates,
                              axis=1)
        self._param("i2h_weight", (rows, self._input_shape[0]) + i2h_kernel,
                    init=i2h_weight_initializer)
        self._param("h2h_weight", (rows, hidden_channels) + h2h_kernel,
                    init=h2h_weight_initializer)
        self._param("i2h_bias", (rows,), init=i2h_bias_initializer)
        self._param("h2h_bias", (rows,), init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}] * self._n_states

    def _convs(self, F, inputs, states, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        return (self._i2h(F, inputs, i2h_weight, i2h_bias),
                self._h2h(F, states[0], h2h_weight, h2h_bias))


class _ConvRNNCell(_BaseConvRNNCell):
    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._convs(F, inputs, states, **params)
        output = self._act(F, i2h + h2h)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    _gates = 4
    _n_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._convs(F, inputs, states, **params)
        i, f, g, o = self._split(F, i2h + h2h)
        i, f, g, o = (self._sigmoid(F, i), self._sigmoid(F, f),
                      self._act(F, g), self._sigmoid(F, o))
        next_c = f * states[1] + i * g
        next_h = o * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _gates = 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._convs(F, inputs, states, **params)
        i2h_r, i2h_z, i2h_o = self._split(F, i2h)
        h2h_r, h2h_z, h2h_o = self._split(F, h2h)
        reset = self._sigmoid(F, i2h_r + h2h_r)
        update = self._sigmoid(F, i2h_z + h2h_z)
        trans = self._act(F, i2h_o + reset * h2h_o)
        out = (1.0 - update) * trans + update * states[0]
        return out, [out]


def _make(name, base, dims, layout, kind):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=(0,) * dims, i2h_dilate=(1,) * dims,
                 h2h_dilate=(1,) * dims, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", conv_layout=layout,
                 activation="tanh", prefix=None, params=None, *,
                 device=None):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                      i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer, dims,
                      conv_layout, activation, prefix, params, device)

    return type(name, (base,), {"__init__": __init__, "__doc__":
                                "%d-D convolutional %s cell over %s data."
                                % (dims, kind, layout)})


Conv1DRNNCell = _make("Conv1DRNNCell", _ConvRNNCell, 1, "NCW", "RNN")
Conv2DRNNCell = _make("Conv2DRNNCell", _ConvRNNCell, 2, "NCHW", "RNN")
Conv3DRNNCell = _make("Conv3DRNNCell", _ConvRNNCell, 3, "NCDHW", "RNN")
Conv1DLSTMCell = _make("Conv1DLSTMCell", _ConvLSTMCell, 1, "NCW", "LSTM")
Conv2DLSTMCell = _make("Conv2DLSTMCell", _ConvLSTMCell, 2, "NCHW", "LSTM")
Conv3DLSTMCell = _make("Conv3DLSTMCell", _ConvLSTMCell, 3, "NCDHW", "LSTM")
Conv1DGRUCell = _make("Conv1DGRUCell", _ConvGRUCell, 1, "NCW", "GRU")
Conv2DGRUCell = _make("Conv2DGRUCell", _ConvGRUCell, 2, "NCHW", "GRU")
Conv3DGRUCell = _make("Conv3DGRUCell", _ConvGRUCell, 3, "NCDHW", "GRU")
