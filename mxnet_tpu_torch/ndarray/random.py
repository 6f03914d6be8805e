"""``mx.nd.random``: sampling into NDArrays.

Counterpart of ``mxnet_tpu/ndarray/random.py`` (reference:
python/mxnet/ndarray/random.py) for ``uniform``, ``normal``, ``randn``,
``randint`` and ``shuffle``.  Samples come from the port's generator of
the target device (:func:`mxnet_tpu_torch.random.generator`), seeded by
:func:`mxnet_tpu_torch.random.seed`.  Distribution parameters given as
NDArrays (the ``_sample_*`` ops) and the other distributions are not
ported yet.
"""

from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .ndarray import NDArray, imperative_invoke

__all__ = ["uniform", "normal", "randn", "randint", "shuffle"]


def _sample(opname, shape, dtype, ctx, out, params):
    for name, v in params.items():
        if isinstance(v, NDArray):
            raise MXNetError("random.%s: distribution parameters given as "
                             "NDArrays (%s) are not ported"
                             % (opname.split("_")[-1], name))
    if out is not None:
        shape, dtype, ctx = out.shape, out.dtype, out.context
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    attrs = dict(params, shape=shape, dtype=dtype or "float32", ctx=ctx)
    return imperative_invoke(opname, [], attrs, out=out)[0]


def uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None, out=None,
            **_):
    """Samples of U[low, high)."""
    return _sample("_random_uniform", shape, dtype, ctx, out,
                   {"low": low, "high": high})


def normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None, out=None,
           **_):
    """Samples of N(loc, scale^2)."""
    return _sample("_random_normal", shape, dtype, ctx, out,
                   {"loc": loc, "scale": scale})


def randn(*shape, **kwargs):
    """numpy-style: the shape as positional ints, then ``loc=``,
    ``scale=``, ``dtype=``, ``ctx=``, ``out=``."""
    if not all(isinstance(d, (int, np.integer)) for d in shape):
        raise TypeError("randn: positional args are shape dims and must be "
                        "ints (got %r); pass loc=/scale= by keyword"
                        % (shape,))
    return normal(kwargs.pop("loc", 0.0), kwargs.pop("scale", 1.0),
                  shape=shape if shape else (1,), **kwargs)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None, **_):
    """Uniform integers in ``[low, high)``."""
    return _sample("_random_randint", shape, dtype, ctx, out,
                   {"low": low, "high": high})


def shuffle(data, out=None, **_):
    """``data`` randomly permuted along axis 0."""
    return imperative_invoke("_shuffle", [data], {}, out=out)[0]
