"""``mx.nd.contrib``: the registered contrib ops of the PyTorch port.

Counterpart of ``mxnet_tpu/ndarray/contrib.py``'s ``_install_contrib_ops``
(reference: python/mxnet/ndarray/contrib.py, filled from the ``_contrib_``
prefix of the C++ registry): one ``mx.nd`` function for every registered
op that has a ``_contrib_`` name, under its canonical name
(``mx.nd.contrib.MultiBoxPrior``, ``mx.nd.contrib.box_nms``), every alias
(``multibox_prior``, ``_contrib_MultiBoxPrior``), as the JAX package's
``register.populate`` installs them, and each ``_contrib_`` name without
the prefix.  ``foreach``, ``while_loop`` and ``cond`` are
not ported yet.
"""

from __future__ import annotations

from ..ops import registry as _reg
from .register import _make_op_func

__all__ = []


def _install_contrib_ops(namespace):
    for name in _reg.list_ops():
        names = (name,) + _reg.get(name).aliases
        short = [n[len("_contrib_"):] for n in names
                 if n.startswith("_contrib_")]
        if not short:
            continue
        f = _make_op_func(name)
        for n in names + tuple(short):
            namespace.setdefault(n, f)
            __all__.append(n)
    return namespace


_install_contrib_ops(globals())
