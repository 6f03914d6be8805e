"""``mx.nd``: the imperative NDArray API of the PyTorch port.

Counterpart of ``mxnet_tpu/ndarray/`` (reference: python/mxnet/ndarray/):
the :class:`NDArray` class, the creation functions, ``save``/``load``,
one generated function per registered op (``mx.nd.dot``,
``mx.nd.FullyConnected``, ...), ``mx.nd.random`` and ``mx.nd.contrib``.
Sparse arrays are not ported yet.
"""

from .. import ops as _ops  # noqa: F401  (registers every op)
from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      imperative_invoke, load, load_frombuffer, maximum,
                      minimum, moveaxis, ones, read_npz, save, stack_arrays,
                      waitall, zeros)
from .register import populate as _populate

_populate(globals())


def onehot_encode(indices, out):
    """The legacy helper (reference: ``mx.nd.onehot_encode``): ``out``
    becomes the one-hot rows of ``indices`` over ``out.shape[1]`` classes,
    in ``out``'s dtype; returns ``out``."""
    res = imperative_invoke("one_hot", [indices], {"depth": out.shape[1]})[0]
    out[:] = res.astype(out.dtype)
    return out

from . import contrib, random  # noqa: E402,F401
