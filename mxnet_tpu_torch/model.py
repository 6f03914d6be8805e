"""Symbolic checkpoints of the PyTorch port.

Counterpart of ``mxnet_tpu/model.py`` ``save_checkpoint`` and
``load_checkpoint`` (reference: python/mxnet/model.py): ``prefix-symbol.json``
(the symbol's JSON) and ``prefix-%04d.params`` (an ``nd.save`` dict of
``arg:<name>`` and ``aux:<name>`` arrays, the JAX package's npz
container), so a checkpoint written by either package loads in the
other.  Each file is written to a temporary name and renamed, so a name
only ever holds a whole file.  The JAX package's sidecar checksum
manifest is neither written nor read.  ``FeedForward`` is not ported.
"""

from __future__ import annotations

import os

from . import ndarray as _nd
from . import symbol as _sym

__all__ = ["save_checkpoint", "load_checkpoint"]


def _replace_into(path, write):
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (unless ``symbol`` is None) and
    ``prefix-%04d.params``."""
    del remove_amp_cast
    if symbol is not None:
        _replace_into("%s-symbol.json" % prefix, symbol.save)
    save = {"arg:%s" % k: v for k, v in arg_params.items()}
    save.update({"aux:%s" % k: v for k, v in aux_params.items()})
    _replace_into("%s-%04d.params" % (prefix, epoch),
                  lambda tmp: _nd.save(tmp, save))


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)``, the arrays on ``ctx``
    (``gpu(0)`` when None)."""
    symbol = _sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in _nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx).items():
        kind, name = k.split(":", 1)
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
