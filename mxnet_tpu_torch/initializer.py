"""Parameter initializers of the PyTorch port.

Counterpart of ``mxnet_tpu/initializer.py``: the same default law and the
same dispatch on the parameter name's suffix (``weight`` draws from the
initializer, ``bias``/``beta`` and ``running_mean`` are zeros, ``gamma``
and ``running_var`` ones).  Draws come
from a ``numpy.random.RandomState``, so a seed gives the same weights on
every device; they cannot match the JAX package's key-based draws.  A
layer's own initializer (``weight_initializer``, ``bias_initializer``,
...) fills its parameter whatever the name, as in the JAX package.
"""

from __future__ import annotations

__all__ = ["Initializer", "Uniform", "Zero", "One", "create"]


class Initializer:
    """Fills a numpy array for a named parameter."""

    def __call__(self, name, arr, rng):
        name = name.lower()
        if name.endswith("weight"):
            self._init_weight(arr, rng)
        elif name.endswith(("bias", "beta", "running_mean")):
            arr[...] = 0.0
        elif name.endswith(("gamma", "running_var")):
            arr[...] = 1.0
        else:
            raise ValueError("Unknown initialization pattern for %s; name a "
                             "known suffix (weight/bias/gamma/beta/"
                             "running_mean/running_var)" % name)

    def _init_weight(self, arr, rng):
        raise NotImplementedError()


class Uniform(Initializer):
    """U(-scale, scale), the framework default (scale 0.07)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, arr, rng):
        arr[...] = rng.uniform(-self.scale, self.scale, size=arr.shape)


class Zero(Initializer):
    """Zeros (reference name ``'zeros'``)."""

    def _init_weight(self, arr, rng):
        arr[...] = 0.0


class One(Initializer):
    """Ones (reference name ``'ones'``)."""

    def _init_weight(self, arr, rng):
        arr[...] = 1.0


_BY_NAME = {"zeros": Zero, "zero": Zero, "ones": One, "one": One,
            "uniform": Uniform}


def create(init):
    """``init`` itself if it is an :class:`Initializer`, else the
    initializer of that name (``'zeros'``, ``'ones'``, ``'uniform'``)."""
    if isinstance(init, Initializer):
        return init
    cls = _BY_NAME.get(str(init).lower())
    if cls is None:
        raise ValueError("unknown initializer %r; the port has %s"
                         % (init, ", ".join(sorted(_BY_NAME))))
    return cls()
