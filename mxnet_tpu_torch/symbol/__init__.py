"""``mx.sym``: the symbolic API of the PyTorch port.

Counterpart of ``mxnet_tpu/symbol/`` (reference: python/mxnet/symbol/):
:class:`Symbol`, ``Variable``/``var``, ``Group``, ``load``/``load_json``
one function per registered op, ``mx.sym.contrib`` and
``mx.sym.random``.  The graph passes and AMP are not ported yet.
"""

from .. import ops as _ops  # noqa: F401  (registers every op)
from .register import populate as _populate
from .symbol import Group, Symbol, Variable, load, load_json, var

_populate(globals())

from . import contrib, random  # noqa: E402,F401

zeros = globals()["_zeros"]
ones = globals()["_ones"]

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "contrib", "random"]
