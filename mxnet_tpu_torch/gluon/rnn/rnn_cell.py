"""Recurrent cells of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference:
python/mxnet/gluon/rnn/rnn_cell.py): ``RecurrentCell`` and
``HybridRecurrentCell``, ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``SequentialRNNCell``, ``HybridSequentialRNNCell``, ``DropoutCell``,
``ZoneoutCell``, ``ResidualCell`` and ``BidirectionalCell``.  A cell
computes one time step on tensors; ``unroll`` loops the steps in Python.
The fused layers of :mod:`.rnn_layer` are the path for long sequences.

The cells take the JAX package's positional arguments, ``prefix`` and
``params`` (another cell's parameters, shared by name), and are named by
its aliases (``rnn``, ``lstm``, ``gru``, ``dropout``, ``zoneout``; the
counter is the one the layers share, so an ``LSTMCell`` made after an
``LSTM`` layer is ``lstm1_``).  Cells with parameters live on ``device``
(default: the current context); ``input_size=0`` takes the input width
from the first step.  They run on tensors and NDArrays; a step of
``RNNCell``, ``LSTMCell``, ``GRUCell``, ``DropoutCell``, ``ResidualCell``
or a stack of them on Symbols builds the JAX package's nodes
(``FullyConnected``, ``SliceChannel``, ``sigmoid``, ``tanh``,
``elemwise_*``, ``_rminus_scalar``).  ``unroll`` over a Symbol raises
:class:`MXNetError`: the JAX package has no such path either.
"""

from __future__ import annotations

import torch

from ... import autograd as _autograd
from ...base import MXNetError
from ...ops import nn as _ops
from ...symbol import Symbol
from ..block import Block, BoundOp, HybridBlock, _contains

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, batch_size=0, **kwargs):
    return sum([c.begin_state(batch_size, **kwargs) for c in cells], [])


def _no_symbol(cell, inputs):
    if isinstance(inputs, Symbol) or (isinstance(inputs, (list, tuple))
                                      and _contains(inputs, Symbol)):
        raise MXNetError("%s.unroll has no Symbol path: the JAX package has "
                         "none either; step the cell on Symbols, or unroll "
                         "it on tensors or NDArrays" % type(cell).__name__)


def _format_sequence(length, inputs, layout, merge):
    """``inputs`` (a tensor of ``layout`` or a list of per-step (N, C)
    tensors) as a list of steps (``merge`` False), a tensor (True) or as
    given (None); with the time axis, the batch size and the length."""
    axis, batch_axis = layout.find("T"), layout.find("N")
    if isinstance(inputs, torch.Tensor):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            if length is not None and length != inputs.shape[axis]:
                raise ValueError("unroll: length %d, but the inputs hold %d "
                                 "steps" % (length, inputs.shape[axis]))
            inputs = list(inputs.unbind(axis))
    else:
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = torch.stack(list(inputs), dim=axis)
    if isinstance(inputs, list):
        length = len(inputs)
    return inputs, axis, batch_size, length


def _sequence_mask(data, valid_length, time_axis):
    """Zero the steps of each sequence at and past its ``valid_length``
    (the JAX package's ``SequenceMask``)."""
    steps = torch.arange(data.shape[time_axis], device=data.device)
    shape = [1] * data.dim()
    shape[time_axis] = data.shape[time_axis]
    lens = [1] * data.dim()
    lens[1 - time_axis] = data.shape[1 - time_axis]
    keep = steps.view(shape) < valid_length.to(data.device).view(lens)
    return torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


def _sequence_last(stacked, valid_length):
    """Each sequence's state at step ``valid_length - 1`` from ``stacked``
    (T, N, ...) (the JAX package's ``SequenceLast``)."""
    idx = (valid_length - 1).to(device=stacked.device, dtype=torch.long)
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


class RecurrentCell(Block):
    """Base of the cells (reference: rnn_cell.py:60)."""

    _port_native = True

    def __init__(self, prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._modified = False
        self.reset()

    def reset(self):
        """Forget what earlier steps left behind (a ZoneoutCell's last
        output), before a new unroll."""
        for cell in self.children():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _check_unmodified(self):
        if self._modified:
            raise MXNetError("this cell is wrapped by a modifier cell: call "
                             "the modifier's begin_state and unroll")

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, each ``func(shape, **kwargs)`` (default
        ``torch.zeros`` on the cell's device)."""
        self._check_unmodified()
        if func is None:
            func = torch.zeros
            if self.device is not None:
                kwargs.setdefault("device", self.device)
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs`` (reference: rnn_cell.py
        unroll): ``(outputs, states)``, the outputs merged into one
        tensor of ``layout`` when ``merge_outputs`` (or, with
        ``valid_length``, unless it is False), else a list of steps.
        With ``valid_length`` (N,), the outputs past each sequence's
        length are zero and each state is the one at its last step."""
        _no_symbol(self, inputs)
        self.reset()
        inputs, axis, batch_size, length = _format_sequence(
            length, inputs, layout, False)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size, device=inputs[0].device,
                             dtype=inputs[0].dtype)
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [_sequence_last(torch.stack([s[i] for s in all_states]),
                                     valid_length)
                      for i in range(len(states))]
            outputs = _sequence_mask(torch.stack(outputs, dim=axis),
                                     valid_length, axis)
            if merge_outputs is False:
                outputs = list(outputs.unbind(axis))
        elif merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, states


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell that :meth:`hybridize` can capture (reference:
    rnn_cell.py HybridRecurrentCell)."""


class _GatedCell(HybridRecurrentCell):
    """A cell of ``gates`` x ``hidden_size`` rows of ``i2h_weight``,
    ``h2h_weight``, ``i2h_bias`` and ``h2h_bias``; its step's two
    projections are ``FullyConnected`` nodes."""

    _gates = 1
    _sigmoid = BoundOp("sigmoid")
    _tanh = BoundOp("tanh")

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params, device):
        super().__init__(prefix=prefix, params=params, device=device)
        self._hidden_size = hidden_size
        self._input_size = input_size
        rows = self._gates * hidden_size
        self._fc = BoundOp("FullyConnected", num_hidden=rows)
        self._split = BoundOp("SliceChannel", num_outputs=self._gates,
                              axis=1)
        self._param("i2h_weight", (rows, input_size),
                    init=i2h_weight_initializer)
        self._param("h2h_weight", (rows, hidden_size),
                    init=h2h_weight_initializer)
        self._param("i2h_bias", (rows,), init=i2h_bias_initializer)
        self._param("h2h_bias", (rows,), init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 x.shape[-1])

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        return (self._fc(F, inputs, i2h_weight, i2h_bias),
                self._fc(F, h, h2h_weight, h2h_bias))


class RNNCell(_GatedCell):
    """Elman cell: ``h' = act(W_i x + b_i + W_h h + b_h)`` (reference:
    rnn_cell.py RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None, *, device=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         device)
        self._activation = activation
        self._act = BoundOp("Activation", act_type=activation) \
            if isinstance(activation, str) else None

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        output = self._act(F, i2h + h2h) if self._act is not None \
            else self._activation(i2h + h2h)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, cuDNN's gate order (i, f, g, o); states ``[h, c]``
    (reference: rnn_cell.py LSTMCell)."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, *, device=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         device)

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        i, f, g, o = self._split(F, i2h + h2h)
        i, f, g, o = (self._sigmoid(F, i), self._sigmoid(F, f),
                      self._tanh(F, g), self._sigmoid(F, o))
        next_c = f * states[1] + i * g
        next_h = o * self._tanh(F, next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, cuDNN's gate order (r, z, n) (reference: rnn_cell.py
    GRUCell)."""

    _gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, *, device=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params,
                         device)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, **params):
        h = states[0]
        i2h, h2h = self._projections(F, inputs, h, **params)
        i2h_r, i2h_z, i2h_n = self._split(F, i2h)
        h2h_r, h2h_z, h2h_n = self._split(F, h2h)
        reset_gate = self._sigmoid(F, i2h_r + h2h_r)
        update_gate = self._sigmoid(F, i2h_z + h2h_z)
        next_h_tmp = self._tanh(F, i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * h
        return next_h, [next_h]


def _run_stack(cells, inputs, states):
    next_states, p = [], 0
    for cell in cells:
        if isinstance(cell, BidirectionalCell):
            raise MXNetError("a BidirectionalCell cannot be stepped; unroll "
                             "the stack")
        n = len(cell.state_info())
        inputs, state = cell(inputs, states[p:p + n])
        p += n
        next_states.extend(state)
    return inputs, next_states


class SequentialRNNCell(RecurrentCell):
    """Cells stacked in order, named ``0``, ``1``, ... (reference:
    rnn_cell.py SequentialRNNCell)."""

    _placeless = True

    def add(self, cell):
        self.add_module(str(len(self._modules)), cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self.children(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        self._check_unmodified()
        return _cells_begin_state(self.children(), batch_size, **kwargs)

    def forward(self, inputs, states):
        return _run_stack(self.children(), inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        _no_symbol(self, inputs)
        self.reset()
        cells = list(self.children())
        if begin_state is None:
            first = inputs if isinstance(inputs, torch.Tensor) else inputs[0]
            begin_state = _cells_begin_state(
                cells, _format_sequence(None, inputs, layout, None)[2],
                device=first.device, dtype=first.dtype)
        p, next_states = 0, []
        for i, cell in enumerate(cells):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < len(cells) - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self.children())[i]

    def __len__(self):
        return len(self._modules)


class HybridSequentialRNNCell(HybridRecurrentCell):
    """A stack of cells that :meth:`hybridize` can capture (reference:
    rnn_cell.py HybridSequentialRNNCell)."""

    _placeless = True

    add = SequentialRNNCell.add
    state_info = SequentialRNNCell.state_info
    begin_state = SequentialRNNCell.begin_state
    forward = SequentialRNNCell.forward
    unroll = SequentialRNNCell.unroll
    __getitem__ = SequentialRNNCell.__getitem__
    __len__ = SequentialRNNCell.__len__


class DropoutCell(HybridRecurrentCell):
    """Dropout of rate ``rate`` on the input, in train mode (reference:
    rnn_cell.py DropoutCell)."""

    _placeless = True

    def __init__(self, rate, axes=(), prefix=None, params=None):
        if not isinstance(rate, (int, float)):
            raise TypeError("rate must be a number, not %r" % (rate,))
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)
        self._drop = BoundOp("Dropout", p=rate, axes=self._axes)

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = self._drop(F, inputs)
        return inputs, states


class _ModifierCell(HybridRecurrentCell):
    """A cell around ``base_cell``, its child ``base_cell`` (reference:
    rnn_cell.py ModifierCell)."""

    _placeless = True

    def __init__(self, base_cell):
        base_cell._check_unmodified()
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + "_modifier_")
        self.base_cell = base_cell
        self._device_arg = base_cell.device

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        self._check_unmodified()
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(batch_size, func=func,
                                              **kwargs)
        finally:
            self.base_cell._modified = True


class ZoneoutCell(_ModifierCell):
    """Zoneout (reference: rnn_cell.py ZoneoutCell): in train mode each
    output unit keeps its previous value with probability
    ``zoneout_outputs``, each state unit with ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, BidirectionalCell):
            raise MXNetError("ZoneoutCell cannot wrap a BidirectionalCell")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        training = _autograd.is_training()

        def zone(p, new, old):
            keep = _ops.dropout(torch.ones_like(new), p=p, training=training)
            return torch.where(keep != 0, new, old)

        prev = self._prev_output
        if prev is None:
            prev = torch.zeros_like(next_output)
        output = zone(self.zoneout_outputs, next_output, prev) \
            if self.zoneout_outputs > 0 else next_output
        new_states = [zone(self.zoneout_states, ns, s)
                      for ns, s in zip(next_states, states)] \
            if self.zoneout_states > 0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(_ModifierCell):
    """The base cell's output plus its input (reference: rnn_cell.py
    ResidualCell); a step on Symbols adds an ``elemwise_add`` node."""

    _symbolic = True

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        _no_symbol(self, inputs)
        self.reset()
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell.unroll(
                length, inputs=inputs, begin_state=begin_state,
                layout=layout, merge_outputs=merge_outputs,
                valid_length=valid_length)
        finally:
            self.base_cell._modified = True
        merge = not isinstance(outputs, list)
        inputs = _format_sequence(length, inputs, layout, merge)[0]
        if merge:
            return outputs + inputs, states
        return [o + i for o, i in zip(outputs, inputs)], states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed, their
    outputs concatenated a step (reference: rnn_cell.py
    BidirectionalCell); it cannot be stepped, only unrolled."""

    _placeless = True

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        del output_prefix  # names nothing in the port
        super().__init__(prefix="")
        self.add_module("l_cell", l_cell)
        self.add_module("r_cell", r_cell)

    def forward(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cell cannot be stepped; use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self.children(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        self._check_unmodified()
        return _cells_begin_state(self.children(), batch_size, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        _no_symbol(self, inputs)
        self.reset()
        inputs, axis, batch_size, length = _format_sequence(
            length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size,
                                           device=inputs[0].device,
                                           dtype=inputs[0].dtype)
        l_cell, r_cell = self.children()
        n = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n:], layout=layout, merge_outputs=False,
            valid_length=valid_length)
        outputs = [torch.cat([lo, ro], dim=1)
                   for lo, ro in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, l_states + r_states
