"""The monolithic multi-layer RNN op (vanilla RNN, LSTM, GRU).

Counterpart of ``mxnet_tpu/ops/rnn.py`` (reference: src/operator/rnn.cc,
the cuDNN path src/operator/cudnn_rnn-inl.h).  The JAX package runs the
recurrence as one ``lax.scan`` per layer and direction, which XLA
compiles; here it is a Python loop over time on tensors.  Each layer and
direction first computes the input projection of every step as one
(T*B, in) x (in, G*H) product, then runs T recurrent (B, H) x (H, G*H)
products, each followed by the cell's element-wise gate math.

The registered ``RNN`` takes the reference's packed parameter vector
(cuDNN's layout: every weight, layer-major, i2h before h2h, then every
bias) and unpacks it (:func:`unpack`); the Gluon layers call
:func:`rnn_forward` with their per-layer tensors directly.  Gate orders
are cuDNN's: LSTM (i, f, g, o), GRU (r, z, n).
"""

from __future__ import annotations

import torch

from .. import autograd as _autograd
from .. import random as _random
from ..base import MXNetError
from .registry import register

__all__ = ["GATES", "rnn_param_size", "unpack", "rnn_forward", "rnn"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _gates(mode):
    if mode not in GATES:
        raise MXNetError("RNN: unknown mode %r (one of %s)"
                         % (mode, ", ".join(sorted(GATES))))
    return GATES[mode]


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """The length of the packed parameter vector (reference: rnn-inl.h
    GetRnnParamSize)."""
    gates = _gates(mode)
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (in_size + state_size + 2)
    return size


def unpack(parameters, num_layers, input_size, state_size, dirs, gates):
    """Views of the packed vector: ``ws[layer * dirs + d]`` is
    ``(w_i2h (G*H, in), w_h2h (G*H, H), b_i2h (G*H,), b_h2h (G*H,))``."""
    n = gates * state_size
    ws, off = [], 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            w_i2h = parameters[off:off + n * in_size].view(n, in_size)
            off += n * in_size
            w_h2h = parameters[off:off + n * state_size].view(n, state_size)
            off += n * state_size
            ws.append([w_i2h, w_h2h])
    for entry in ws:
        entry.append(parameters[off:off + n])
        entry.append(parameters[off + n:off + 2 * n])
        off += 2 * n
    if off != parameters.numel():
        raise MXNetError("RNN: %d parameters given, the layout needs %d"
                         % (parameters.numel(), off))
    return [tuple(entry) for entry in ws]


def _lstm_step(clip_min, clip_max):
    def step(h, c, gx, w_h2h, b_h2h):
        g = gx + h @ w_h2h.t() + b_h2h
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        if clip_min is not None:
            # every step, not just the final state (cuDNN's clip mode)
            c = c.clamp(clip_min, clip_max)
        return torch.sigmoid(o) * torch.tanh(c), c
    return step


def _gru_step(h, c, gx, w_h2h, b_h2h):
    gh = h @ w_h2h.t() + b_h2h
    xr, xz, xn = gx.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, c


def _vanilla_step(act):
    def step(h, c, gx, w_h2h, b_h2h):
        return act(gx + h @ w_h2h.t() + b_h2h), c
    return step


def _step(mode, clip_min, clip_max):
    if mode == "lstm":
        return _lstm_step(clip_min, clip_max)
    if mode == "gru":
        return _gru_step
    return _vanilla_step(torch.relu if mode == "rnn_relu" else torch.tanh)


def _run_direction(x, h, c, w_i2h, w_h2h, b_i2h, b_h2h, step, reverse):
    """One layer, one direction over x (T, B, in): the outputs (T, B, H)
    in time order and the last (h, c)."""
    t_len, batch = x.shape[0], x.shape[1]
    # the input projection of every step in one product
    gates_x = (x.reshape(t_len * batch, -1) @ w_i2h.t() + b_i2h) \
        .view(t_len, batch, -1)
    ys = [None] * t_len
    for t in (reversed(range(t_len)) if reverse else range(t_len)):
        h, c = step(h, c, gates_x[t], w_h2h, b_h2h)
        ys[t] = h
    return torch.stack(ys), h, c


def rnn_forward(data, weights, state, state_cell=None, mode="lstm",
                num_layers=1, bidirectional=False, p=0.0, training=False,
                clip_min=None, clip_max=None):
    """The recurrence over ``data`` (T, B, in) with per-(layer, direction)
    ``weights`` as :func:`unpack` gives them; ``state`` and, for an LSTM,
    ``state_cell`` are (layers * dirs, B or 1, H) (a batch of 1
    broadcasts).  Dropout of rate ``p`` applies between layers only, in
    ``training``, drawn from the port's generator of the data's device.
    Returns ``(output (T, B, H * dirs), h_n, c_n or None)``."""
    dirs = 2 if bidirectional else 1
    step = _step(mode, clip_min, clip_max)
    batch = data.shape[1]
    x = data
    h_out, c_out = [], []
    for layer in range(num_layers):
        if layer > 0 and p > 0.0 and training:
            keep = torch.full(x.shape, 1.0 - p, dtype=torch.float32,
                              device=x.device)
            mask = torch.bernoulli(keep,
                                   generator=_random.generator(x.device))
            x = x * (mask.to(x.dtype) / (1.0 - p))
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            h0 = state[idx].expand(batch, -1)
            c0 = state_cell[idx].expand(batch, -1) if mode == "lstm" \
                else None
            ys, h, c = _run_direction(x, h0, c0, *weights[idx], step,
                                      reverse=d == 1)
            outs.append(ys)
            h_out.append(h)
            c_out.append(c)
        x = torch.cat(outs, dim=-1) if dirs == 2 else outs[0]
    return (x, torch.stack(h_out),
            torch.stack(c_out) if mode == "lstm" else None)


def _rnn_nout(attrs):
    if not attrs.get("state_outputs"):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


@register("RNN", num_outputs=_rnn_nout)
def rnn(data, parameters, state, state_cell=None, state_size=0,
        num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        state_outputs=False, projection_size=None, use_sequence_length=False,
        sequence_length=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False, **_):
    """The registered ``RNN`` (reference: src/operator/rnn.cc): ``data``
    (T, B, in), the packed ``parameters``, ``state`` (and for an LSTM
    ``state_cell``) of (layers * dirs, B, H).  The output (T, B, H *
    dirs), or with ``state_outputs`` the output and the final states.
    Inter-layer dropout ``p`` runs in train mode only
    (:func:`~mxnet_tpu_torch.autograd.is_training`), as the JAX package's
    inference pass drops nothing.  ``lstm_state_clip_nan`` is accepted
    and, as in the JAX package, has no effect; projections and sequence
    lengths are not ported and raise."""
    del sequence_length, lstm_state_clip_nan
    if projection_size is not None or use_sequence_length:
        raise MXNetError("RNN: projection_size and use_sequence_length are "
                         "not ported")
    mode = str(mode)
    gates = _gates(mode)
    num_layers, state_size = int(num_layers), int(state_size)
    dirs = 2 if bidirectional else 1
    if mode == "lstm" and state_cell is None:
        raise MXNetError("RNN: mode 'lstm' needs state_cell")
    weights = unpack(parameters, num_layers, data.shape[2], state_size,
                     dirs, gates)
    out, h, c = rnn_forward(
        data, weights, state, state_cell, mode=mode, num_layers=num_layers,
        bidirectional=bool(bidirectional), p=float(p),
        training=_autograd.is_training(), clip_min=lstm_state_clip_min,
        clip_max=lstm_state_clip_max)
    if not state_outputs:
        return out
    return (out, h, c) if mode == "lstm" else (out, h)
