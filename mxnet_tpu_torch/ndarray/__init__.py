"""``mx.nd``: the imperative NDArray API of the PyTorch port.

Counterpart of ``mxnet_tpu/ndarray/`` (reference: python/mxnet/ndarray/):
the :class:`NDArray` class, the creation functions, ``save``/``load``,
one generated function per registered op (``mx.nd.dot``,
``mx.nd.FullyConnected``, ...), ``mx.nd.random`` and ``mx.nd.contrib``.
Sparse arrays are not ported yet.
"""

from .. import ops as _ops  # noqa: F401  (registers every op)
from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      imperative_invoke, load, maximum, minimum, moveaxis,
                      ones, read_npz, save, stack_arrays, waitall, zeros)
from .register import populate as _populate

_populate(globals())

from . import contrib, random  # noqa: E402,F401
