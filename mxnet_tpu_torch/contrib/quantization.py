"""``contrib.quantization`` of the PyTorch port: :func:`_trace_block`
alone (``mxnet_tpu/contrib/quantization.py:439-455``), over the Gluon
blocks' Symbol path.  The quantization passes themselves wait for
ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

__all__ = ["_trace_block"]


def _trace_block(network, data_syms, data_shapes):
    """``(Symbol, {name: parameter NDArray})`` of a HybridBlock: one
    forward on zeros of ``data_shapes`` (on the current context) makes
    every parameter's shape, then the block is called on ``data_syms``."""
    from ..ndarray import zeros
    from ..symbol.symbol import Group

    network(*[zeros(s) for s in data_shapes])
    sym = network(*data_syms)
    if isinstance(sym, (list, tuple)):
        sym = Group(list(sym))
    params = {name: p.data()
              for name, p in network.collect_params().items()}
    return sym, params
