"""Symbolic recurrent cells of the PyTorch port (``mx.rnn``).

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference:
python/mxnet/rnn/rnn_cell.py).  A cell builds a Symbol step by step: its
``unroll`` is a Python loop over time that adds each step's nodes to the
graph, which the executor then runs node by node (one captured CUDA graph
a bound executor on the card).  :class:`FusedRNNCell` emits the registered
``RNN`` op (``ops/rnn.py``) over its one packed parameter vector.

The parameter names are the JAX package's (and MXNet's), so that
checkpoints cross both ways: packed, ``{prefix}i2h_weight``,
``i2h_bias``, ``h2h_weight``, ``h2h_bias``; unpacked, the gate suffix
inserted (``{prefix}i2h{gate}_weight``, gates ``_i, _f, _c, _o`` for an
LSTM and ``_r, _z, _o`` for a GRU).  The fused cell's vector is
``{prefix}parameters`` in cuDNN's layout, gates-major, as ``ops/rnn.py``
reads it; its unpacked names add ``l{layer}_``/``r{layer}_`` per layer and
direction.

The begin state follows the JAX package, not MXNet: a state made by
``zeros`` (the default) has batch 1 and broadcasts against the true batch
at its first use; one made by ``Variable`` keeps MXNet's 0 batch
dimension, which shape inference solves at bind (partial shapes) or a
Module's ``state_names`` sets.
"""

from __future__ import annotations

import numpy as np

from .. import symbol
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "BaseConvRNNCell", "ConvRNNCell",
           "ConvLSTMCell", "ConvGRUCell"]

# gate suffixes in the fused op's (cuDNN's) order, which the unfused
# cells compute in too
_GATES = {
    "rnn_relu": ("",),
    "rnn_tanh": ("",),
    "lstm": ("_i", "_f", "_c", "_o"),
    "gru": ("_r", "_z", "_o"),
}


class RNNParams:
    """Variables shared between cells, by prefixed name (reference:
    rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = symbol.Variable(full, **kwargs)
        return self._params[full]


def _sum_states(cells, member, *args, **kwargs):
    """A list-valued member of each cell, concatenated."""
    out = []
    for c in cells:
        v = getattr(c, member)
        out.extend(v(*args, **kwargs) if callable(v) else v)
    return out


def _chain_dicts(cells, member, args):
    for c in cells:
        args = getattr(c, member)(args)
    return args


def _as_steps(inputs, length, layout):
    """``inputs`` as a list of per-step (B, ...) symbols, and the time
    axis of ``layout``."""
    t_axis = layout.find("T")
    if isinstance(inputs, symbol.Symbol):
        if len(inputs.list_outputs()) != 1:
            raise MXNetError("unroll: grouped symbols are ambiguous; pass "
                             "a list of per-step symbols instead")
        steps = list(symbol.SliceChannel(inputs, axis=t_axis,
                                         num_outputs=length,
                                         squeeze_axis=1))
        return steps, t_axis
    if length is not None and len(inputs) != length:
        raise MXNetError("unroll: got %d inputs for length=%d"
                         % (len(inputs), length))
    return list(inputs), t_axis


def _as_merged(outputs, t_axis):
    """Per-step symbols stacked along ``t_axis`` into one symbol."""
    expanded = [symbol.expand_dims(o, axis=t_axis) for o in outputs]
    return symbol.Concat(*expanded, dim=t_axis)


def _shape_outputs(outputs, length, layout, merge):
    """``outputs`` (a list or one merged symbol) as ``merge`` asks: None
    leaves them, True merges, False splits."""
    t_axis = layout.find("T")
    is_merged = isinstance(outputs, symbol.Symbol)
    if merge is None:
        return outputs
    if merge and not is_merged:
        return _as_merged(outputs, t_axis)
    if not merge and is_merged:
        return list(symbol.SliceChannel(outputs, axis=t_axis,
                                        num_outputs=length, squeeze_axis=1))
    return outputs


class BaseRNNCell:
    """A symbolic cell: one step by ``__call__``, a sequence by
    ``unroll`` (reference: rnn_cell.py BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._params = RNNParams(prefix) if params is None else params
        self._prefix = prefix
        self._modified = False
        self.reset()

    def reset(self):
        """Restart the step and state counters, so that the cell can build
        a new graph."""
        self._counter = -1
        self._init_counter = -1
        for c in getattr(self, "_cells", ()):
            c.reset()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """The initial states, made by ``func`` (``symbol.zeros`` by
        default: batch 1, broadcast at first use; ``symbol.Variable``:
        MXNet's 0 batch dimension, solved at bind)."""
        if self._modified:
            raise MXNetError(
                "cell was wrapped by a modifier (Zoneout/Residual/...); "
                "request begin_state from the modifier instead")
        func = func or symbol.zeros
        states = []
        for info in self.state_info:
            self._init_counter += 1
            kw = dict(kwargs)
            if info is not None:
                kw.update(info)
            if "shape" in kw and func is not symbol.Variable:
                kw["shape"] = tuple(1 if d == 0 else d for d in kw["shape"])
            kw.pop("__layout__", None)
            states.append(func(
                name="%sbegin_state_%d" % (self._prefix, self._init_counter),
                **kw))
        return states

    def unpack_weights(self, args):
        """The packed i2h and h2h matrices and biases split into per-gate
        entries (copies)."""
        gates = self._gate_names
        if not gates:
            return dict(args)
        out = dict(args)
        h = self._num_hidden
        for part in ("i2h", "h2h"):
            w = out.pop("%s%s_weight" % (self._prefix, part))
            b = out.pop("%s%s_bias" % (self._prefix, part))
            for j, g in enumerate(gates):
                out["%s%s%s_weight" % (self._prefix, part, g)] = \
                    w[j * h:(j + 1) * h].copy()
                out["%s%s%s_bias" % (self._prefix, part, g)] = \
                    b[j * h:(j + 1) * h].copy()
        return out

    def pack_weights(self, args):
        """The inverse of :meth:`unpack_weights`."""
        gates = self._gate_names
        if not gates:
            return dict(args)
        from .. import ndarray as nd

        out = dict(args)
        for part in ("i2h", "h2h"):
            ws, bs = [], []
            for g in gates:
                ws.append(out.pop("%s%s%s_weight" % (self._prefix, part, g)))
                bs.append(out.pop("%s%s%s_bias" % (self._prefix, part, g)))
            out["%s%s_weight" % (self._prefix, part)] = nd.concatenate(ws)
            out["%s%s_bias" % (self._prefix, part)] = nd.concatenate(bs)
        return out

    def __call__(self, inputs, states):
        """One step: (B, in) and the states give the output (B, H) and
        the next states."""
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """``length`` steps over ``inputs`` (one symbol with a time axis
        in ``layout``, or a list of per-step symbols): the outputs (a list,
        or one symbol when ``merge_outputs``) and the last states."""
        self.reset()
        steps, t_axis = _as_steps(inputs, length, layout)
        states = begin_state if begin_state is not None else \
            self.begin_state()
        outputs = []
        for x in steps:
            out, states = self(x, states)
            outputs.append(out)
        if merge_outputs:
            return _as_merged(outputs, t_axis), states
        return outputs, states

    def _activate(self, x, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(x, act_type=activation, **kwargs)
        return activation(x, **kwargs)

    def _step_name(self):
        self._counter += 1
        return "%st%d_" % (self._prefix, self._counter)


class _SingleGateSetCell(BaseRNNCell):
    """A cell with one i2h and one h2h product a step."""

    def __init__(self, num_hidden, prefix, params, i2h_bias_init=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        p = self.params
        self._w = {"i2h_weight": p.get("i2h_weight"),
                   "h2h_weight": p.get("h2h_weight"),
                   "h2h_bias": p.get("h2h_bias"),
                   "i2h_bias": p.get("i2h_bias", init=i2h_bias_init)
                   if i2h_bias_init is not None else p.get("i2h_bias")}

    def _projections(self, inputs, h_prev, step_name):
        n = self._num_hidden * len(self._gate_names)
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._w["i2h_weight"],
            bias=self._w["i2h_bias"], num_hidden=n,
            name="%si2h" % step_name)
        h2h = symbol.FullyConnected(
            data=h_prev, weight=self._w["h2h_weight"],
            bias=self._w["h2h_bias"], num_hidden=n,
            name="%sh2h" % step_name)
        return i2h, h2h


class RNNCell(_SingleGateSetCell):
    """Elman cell: h' = act(W_x x + b_x + W_h h + b_h) (reference:
    rnn_cell.py RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(num_hidden, prefix, params)
        self._activation = activation

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        name = self._step_name()
        i2h, h2h = self._projections(inputs, states[0], name)
        out = self._activate(i2h + h2h, self._activation,
                             name="%sout" % name)
        return out, [out]


class LSTMCell(_SingleGateSetCell):
    """LSTM cell, gates (i, f, c, o), the forget bias in i2h_bias's
    initializer (reference: rnn_cell.py LSTMCell)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        from ..initializer import LSTMBias

        super().__init__(num_hidden, prefix, params,
                         i2h_bias_init=LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        name = self._step_name()
        i2h, h2h = self._projections(inputs, states[0], name)
        g_i, g_f, g_c, g_o = symbol.SliceChannel(
            i2h + h2h, num_outputs=4, name="%sslice" % name)
        i = symbol.Activation(g_i, act_type="sigmoid", name="%si" % name)
        f = symbol.Activation(g_f, act_type="sigmoid", name="%sf" % name)
        c_tilde = symbol.Activation(g_c, act_type="tanh", name="%sc" % name)
        o = symbol.Activation(g_o, act_type="sigmoid", name="%so" % name)
        next_c = symbol.elemwise_add(f * states[1], i * c_tilde,
                                     name="%sstate" % name)
        next_h = symbol.elemwise_mul(
            o, symbol.Activation(next_c, act_type="tanh"),
            name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(_SingleGateSetCell):
    """GRU cell as cuDNN computes it, the reset gate applied to the h2h
    projection (reference: rnn_cell.py GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(num_hidden, prefix, params)

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        name = self._step_name()
        h_prev = states[0]
        i2h, h2h = self._projections(inputs, h_prev, name)
        xr, xz, xn = symbol.SliceChannel(i2h, num_outputs=3,
                                         name="%s_i2h_slice" % name)
        hr, hz, hn = symbol.SliceChannel(h2h, num_outputs=3,
                                         name="%s_h2h_slice" % name)
        r = symbol.Activation(xr + hr, act_type="sigmoid",
                              name="%s_r_act" % name)
        z = symbol.Activation(xz + hz, act_type="sigmoid",
                              name="%s_z_act" % name)
        cand = symbol.Activation(xn + r * hn, act_type="tanh",
                                 name="%s_h_act" % name)
        next_h = symbol.elemwise_add((1.0 - z) * cand, z * h_prev,
                                     name="%sout" % name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """A whole stack as one registered ``RNN`` op over one packed vector
    (reference: rnn_cell.py FusedRNNCell).  :meth:`unpack_weights` gives
    the per-layer, per-direction, per-gate names of :meth:`unfuse`'s
    stack, so that fused and unfused checkpoints cross."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        from ..initializer import FusedRNN

        prefix = "%s_" % mode if prefix is None else prefix
        super().__init__(prefix=prefix, params=params)
        if mode not in _GATES:
            raise MXNetError("unknown RNN mode %r" % (mode,))
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ("l", "r") if bidirectional else ("l",)
        self._parameter = self.params.get(
            "parameters", init=FusedRNN(None, num_hidden, num_layers, mode,
                                        bidirectional, forget_bias))

    @property
    def state_info(self):
        depth = len(self._directions) * self._num_layers
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (depth, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return _GATES[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _walk_slices(self, num_input):
        """``(unpacked name, offset, shape)`` over the packed vector in the
        order ``ops/rnn.py`` reads it: every weight (layer, direction, the
        i2h gates, the h2h gates), then every bias."""
        h = self._num_hidden
        b = len(self._directions)
        pos = 0

        def cell_pieces(stem, kind, in_dim):
            nonlocal pos
            shape = (h, in_dim) if kind.endswith("weight") else (h,)
            n = h * in_dim if kind.endswith("weight") else h
            for g in self._gate_names:
                start = pos
                pos += n
                yield "%s%s%s_%s" % (stem, kind[:3], g, kind[4:]), start, \
                    shape

        for layer in range(self._num_layers):
            in_dim = num_input if layer == 0 else h * b
            for d in self._directions:
                stem = "%s%s%d_" % (self._prefix, d, layer)
                yield from cell_pieces(stem, "i2h_weight", in_dim)
                yield from cell_pieces(stem, "h2h_weight", h)
        for layer in range(self._num_layers):
            for d in self._directions:
                stem = "%s%s%d_" % (self._prefix, d, layer)
                yield from cell_pieces(stem, "i2h_bias", 1)
                yield from cell_pieces(stem, "h2h_bias", 1)

    def _infer_num_input(self, total):
        h, b, m = self._num_hidden, len(self._directions), self._num_gates
        return total // (b * h * m) - (self._num_layers - 1) * \
            (h + b * h + 2) - h - 2

    def slices(self, total):
        """``(unpacked name, offset, shape)`` of each piece of a packed
        vector of ``total`` elements."""
        return list(self._walk_slices(self._infer_num_input(total)))

    def unpack_weights(self, args):
        out = dict(args)
        vec = out.pop(self._parameter.name)
        consumed = 0
        for name, start, shape in self.slices(vec.size):
            n = int(np.prod(shape))
            out[name] = vec[start:start + n].reshape(shape).copy()
            consumed += n
        if consumed != vec.size:
            raise MXNetError("packed parameter size %d does not match the "
                             "cell spec" % vec.size)
        return out

    def pack_weights(self, args):
        from ..ndarray import array

        out = dict(args)
        w0 = out["%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])]
        ni = w0.shape[1]
        h, b, m = self._num_hidden, len(self._directions), self._num_gates
        total = (ni + h + 2) * h * m * b + \
            (self._num_layers - 1) * m * h * (h + b * h + 2) * b
        # assembled on the host, one copy to the device at the end
        flat = np.zeros((total,), dtype=np.float32)
        for name, start, shape in self._walk_slices(ni):
            piece = out.pop(name)
            piece = piece.asnumpy() if hasattr(piece, "asnumpy") \
                else np.asarray(piece)
            flat[start:start + piece.size] = piece.reshape(-1)
        out[self._parameter.name] = array(flat, ctx=w0.context,
                                          dtype=w0.dtype)
        return out

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell has no per-step form; use unroll() "
                         "or unfuse()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        t_axis = layout.find("T")
        if not isinstance(inputs, symbol.Symbol):
            inputs = _as_merged(list(inputs), t_axis)
        if t_axis == 1:  # the RNN op is time-major
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        states = begin_state if begin_state is not None else \
            self.begin_state()
        state_kw = {"state": states[0]}
        if self._mode == "lstm":
            state_kw["state_cell"] = states[1]
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **state_kw)
        if not self._get_next_state:
            outputs, out_states = rnn, []
        else:
            n_state = 2 if self._mode == "lstm" else 1
            outputs = rnn[0]
            out_states = [rnn[1 + i] for i in range(n_state)]
            for s in out_states:
                s._set_attr(__layout__="LNC")
        if t_axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        outputs = _shape_outputs(outputs, length, layout, merge_outputs)
        return outputs, out_states

    def unfuse(self):
        """The equivalent stack of one-layer cells, under the unpacked
        names (reference: FusedRNNCell.unfuse)."""
        make = {
            "rnn_relu": lambda pre: RNNCell(self._num_hidden,
                                            activation="relu", prefix=pre),
            "rnn_tanh": lambda pre: RNNCell(self._num_hidden,
                                            activation="tanh", prefix=pre),
            "lstm": lambda pre: LSTMCell(self._num_hidden, prefix=pre),
            "gru": lambda pre: GRUCell(self._num_hidden, prefix=pre),
        }[self._mode]
        stack = SequentialRNNCell()
        for layer in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make("%sl%d_" % (self._prefix, layer)),
                    make("%sr%d_" % (self._prefix, layer)),
                    output_prefix="%sbi_l%d_" % (self._prefix, layer)))
            else:
                stack.add(make("%sl%d_" % (self._prefix, layer)))
            if self._dropout > 0 and layer != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, layer)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Cells stacked vertically (reference: SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            if not cell._own_params:
                raise MXNetError("give params to the stack or to the "
                                 "child cells, not both")
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _sum_states(self._cells, "state_info")

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("request begin_state from the modifier cell")
        return _sum_states(self._cells, "begin_state", **kwargs)

    def unpack_weights(self, args):
        return _chain_dicts(self._cells, "unpack_weights", args)

    def pack_weights(self, args):
        return _chain_dicts(self._cells, "pack_weights", args)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._cells:
            if isinstance(cell, BidirectionalCell):
                raise MXNetError("BidirectionalCell cannot be stepped "
                                 "inside a stack; use unroll")
            n = len(cell.state_info)
            inputs, sub = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(sub)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        states = begin_state if begin_state is not None else \
            self.begin_state()
        pos = 0
        next_states = []
        last = len(self._cells) - 1
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            inputs, sub = cell.unroll(
                length, inputs=inputs, begin_state=states[pos:pos + n],
                layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            pos += n
            next_states.extend(sub)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on the input, no state (reference: DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        if not isinstance(dropout, (int, float)):
            raise MXNetError("dropout probability must be numeric")
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if isinstance(inputs, symbol.Symbol) and merge_outputs is not False:
            # element-wise: once over the merged sequence
            return self(inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """A cell wrapped to change its steps; the parameters stay the base
    cell's (reference: ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        if self._modified:
            raise MXNetError("request begin_state from the outermost "
                             "modifier cell")
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout: each output and state kept from the step before with a
    probability (reference: ZoneoutCell; Krueger et al. 2016)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, FusedRNNCell):
            raise MXNetError("unfuse() the cell before applying zoneout")
        if isinstance(base_cell, BidirectionalCell):
            raise MXNetError("apply zoneout to the cells inside the "
                             "BidirectionalCell instead")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)

        def held(p, new, old):
            keep = symbol.Dropout(symbol.ones_like(new), p=p)
            return symbol.where(keep, new, old)

        if self.zoneout_outputs > 0.0:
            prev = self._prev_output
            if prev is None:
                prev = symbol.zeros(shape=(1, 1))
            out = held(self.zoneout_outputs, out, prev)
        if self.zoneout_states > 0.0:
            next_states = [held(self.zoneout_states, n, o)
                           for n, o in zip(next_states, states)]
        self._prev_output = out
        return out, next_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input (reference: ResidualCell;
    Wu et al. 2016)."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        out = symbol.elemwise_add(out, inputs,
                                  name="%s_plus_residual" % out.name)
        return out, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell.unroll(
                length, inputs=inputs, begin_state=begin_state,
                layout=layout, merge_outputs=merge_outputs)
        finally:
            self.base_cell._modified = True
        merged = isinstance(outputs, symbol.Symbol) \
            if merge_outputs is None else merge_outputs
        t_axis = layout.find("T")
        if merged:
            if not isinstance(inputs, symbol.Symbol):
                inputs = _as_merged(list(inputs), t_axis)
            outputs = symbol.elemwise_add(
                outputs, inputs, name="%s_plus_residual" % outputs.name)
        else:
            steps, _ = _as_steps(inputs, length, layout)
            outputs = [symbol.elemwise_add(o, x,
                                           name="%s_plus_residual" % o.name)
                       for o, x in zip(outputs, steps)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """One cell forward and one backward over the sequence, their outputs
    concatenated a step (reference: BidirectionalCell).  As in the JAX
    package, ``unroll`` returns the states as one flat list, the left
    cell's then the right's (MXNet nests them)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            if not (l_cell._own_params and r_cell._own_params):
                raise MXNetError("give params to the BidirectionalCell or "
                                 "to the child cells, not both")
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    @property
    def state_info(self):
        return _sum_states(self._cells, "state_info")

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("request begin_state from the modifier cell")
        return _sum_states(self._cells, "begin_state", **kwargs)

    def unpack_weights(self, args):
        return _chain_dicts(self._cells, "unpack_weights", args)

    def pack_weights(self, args):
        return _chain_dicts(self._cells, "pack_weights", args)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell sees the whole sequence; "
                         "use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, t_axis = _as_steps(inputs, length, layout)
        states = begin_state if begin_state is not None else \
            self.begin_state()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_out, l_states = l_cell.unroll(length, inputs=steps,
                                        begin_state=states[:n_l],
                                        layout=layout, merge_outputs=False)
        r_out, r_states = r_cell.unroll(length,
                                        inputs=list(reversed(steps)),
                                        begin_state=states[n_l:],
                                        layout=layout, merge_outputs=False)
        r_out = list(reversed(r_out))
        outputs = [symbol.Concat(lo, ro, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (lo, ro) in enumerate(zip(l_out, r_out))]
        if merge_outputs:
            outputs = _as_merged(outputs, t_axis)
        return outputs, l_states + r_states


class BaseConvRNNCell(BaseRNNCell):
    """A recurrence whose i2h and h2h are Convolutions over spatial state
    maps (reference: rnn_cell.py BaseConvRNNCell).  The h2h kernel is odd,
    so that its SAME padding keeps the state's shape."""

    def __init__(self, input_shape, num_hidden, h2h_kernel, h2h_dilate,
                 i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, activation,
                 prefix="", params=None, conv_layout="NCHW"):
        super().__init__(prefix=prefix, params=params)
        if h2h_kernel[0] % 2 != 1 or h2h_kernel[1] % 2 != 1:
            raise MXNetError("h2h_kernel must be odd (SAME padding), got %s"
                             % (h2h_kernel,))
        self._h2h_kernel = tuple(h2h_kernel)
        self._h2h_dilate = tuple(h2h_dilate)
        self._h2h_pad = (h2h_dilate[0] * (h2h_kernel[0] - 1) // 2,
                         h2h_dilate[1] * (h2h_kernel[1] - 1) // 2)
        self._i2h_kernel = tuple(i2h_kernel)
        self._i2h_stride = tuple(i2h_stride)
        self._i2h_pad = tuple(i2h_pad)
        self._i2h_dilate = tuple(i2h_dilate)
        self._num_hidden = num_hidden
        self._input_shape = tuple(input_shape)
        self._conv_layout = conv_layout
        self._activation = activation

        # the state's spatial shape: the i2h convolution of one step's input
        probe = symbol.Convolution(
            symbol.Variable("data"), num_filter=num_hidden,
            kernel=self._i2h_kernel, stride=self._i2h_stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate, layout=conv_layout)
        _, out_shapes, _ = probe.infer_shape(data=self._input_shape)
        self._state_shape = (0,) + tuple(out_shapes[0][1:])

        p = self.params
        self._w = {
            "i2h_weight": p.get("i2h_weight", init=i2h_weight_initializer),
            "h2h_weight": p.get("h2h_weight", init=h2h_weight_initializer),
            "i2h_bias": p.get("i2h_bias", init=i2h_bias_initializer),
            "h2h_bias": p.get("h2h_bias", init=h2h_bias_initializer),
        }

    @property
    def _num_gates(self):
        return len(self._gate_names)

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def _conv_projections(self, inputs, h_prev, step_name):
        n = self._num_hidden * self._num_gates
        i2h = symbol.Convolution(
            data=inputs, weight=self._w["i2h_weight"],
            bias=self._w["i2h_bias"], num_filter=n,
            kernel=self._i2h_kernel, stride=self._i2h_stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate,
            layout=self._conv_layout, name="%si2h" % step_name)
        h2h = symbol.Convolution(
            data=h_prev, weight=self._w["h2h_weight"],
            bias=self._w["h2h_bias"], num_filter=n,
            kernel=self._h2h_kernel, stride=(1, 1), pad=self._h2h_pad,
            dilate=self._h2h_dilate, layout=self._conv_layout,
            name="%sh2h" % step_name)
        return i2h, h2h


def _leaky(x, name=None):
    return symbol.LeakyReLU(x, act_type="leaky", slope=0.2, name=name)


class ConvRNNCell(BaseConvRNNCell):
    """h' = act(conv(x) + conv(h)) (reference: rnn_cell.py ConvRNNCell)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 activation=_leaky, prefix="ConvRNN_", params=None,
                 conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         activation, prefix, params, conv_layout)

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        name = self._step_name()
        i2h, h2h = self._conv_projections(inputs, states[0], name)
        out = self._activate(i2h + h2h, self._activation,
                             name="%sout" % name)
        return out, [out]


class ConvLSTMCell(BaseConvRNNCell):
    """Convolutional LSTM (reference: rnn_cell.py ConvLSTMCell; Shi
    Xingjian et al. 2015)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 activation=_leaky, prefix="ConvLSTM_", params=None,
                 conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         activation, prefix, params, conv_layout)

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout},
                {"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def __call__(self, inputs, states):
        name = self._step_name()
        i2h, h2h = self._conv_projections(inputs, states[0], name)
        c_axis = self._conv_layout.find("C")
        g_i, g_f, g_c, g_o = symbol.SliceChannel(
            i2h + h2h, num_outputs=4, axis=c_axis, name="%sslice" % name)
        i = symbol.Activation(g_i, act_type="sigmoid", name="%si" % name)
        f = symbol.Activation(g_f, act_type="sigmoid", name="%sf" % name)
        c_tilde = self._activate(g_c, self._activation, name="%sc" % name)
        o = symbol.Activation(g_o, act_type="sigmoid", name="%so" % name)
        next_c = symbol.elemwise_add(f * states[1], i * c_tilde,
                                     name="%sstate" % name)
        next_h = symbol.elemwise_mul(
            o, self._activate(next_c, self._activation),
            name="%sout" % name)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Convolutional GRU (reference: rnn_cell.py ConvGRUCell)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 activation=_leaky, prefix="ConvGRU_", params=None,
                 conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         activation, prefix, params, conv_layout)

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        name = self._step_name()
        h_prev = states[0]
        i2h, h2h = self._conv_projections(inputs, h_prev, name)
        c_axis = self._conv_layout.find("C")
        xr, xz, xn = symbol.SliceChannel(i2h, num_outputs=3, axis=c_axis,
                                         name="%s_i2h_slice" % name)
        hr, hz, hn = symbol.SliceChannel(h2h, num_outputs=3, axis=c_axis,
                                         name="%s_h2h_slice" % name)
        r = symbol.Activation(xr + hr, act_type="sigmoid",
                              name="%s_r_act" % name)
        z = symbol.Activation(xz + hz, act_type="sigmoid",
                              name="%s_z_act" % name)
        cand = self._activate(xn + r * hn, self._activation,
                              name="%s_h_act" % name)
        next_h = symbol.elemwise_add((1.0 - z) * cand, z * h_prev,
                                     name="%sout" % name)
        return next_h, [next_h]
