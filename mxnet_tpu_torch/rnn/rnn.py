"""Checkpoints of symbolic recurrent cells in the PyTorch port.

Counterpart of ``mxnet_tpu/rnn/rnn.py`` (reference:
python/mxnet/rnn/rnn.py).  A checkpoint holds every cell's weights
unpacked (per-gate names), so that it loads into fused and unfused cells
alike and in either package; loading packs them for the cells given.
"""

from __future__ import annotations

import warnings

from ..model import load_checkpoint, save_checkpoint
from .rnn_cell import BaseRNNCell

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def _as_cell_list(cells):
    return [cells] if isinstance(cells, BaseRNNCell) else list(cells)


def rnn_unroll(cell, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC"):
    """Deprecated: ``cell.unroll``."""
    del input_prefix
    warnings.warn("rnn_unroll is deprecated; call cell.unroll directly")
    return cell.unroll(length=length, inputs=inputs,
                       begin_state=begin_state, layout=layout)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """``save_checkpoint`` with every cell's weights unpacked."""
    for cell in _as_cell_list(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch, ctx=None):
    """A checkpoint of :func:`save_rnn_checkpoint`, its weights packed for
    ``cells``, the arrays on ``ctx`` (``gpu(0)`` when None)."""
    sym, arg, aux = load_checkpoint(prefix, epoch, ctx=ctx)
    for cell in _as_cell_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback that saves through
    :func:`save_rnn_checkpoint` every ``period`` epochs."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
