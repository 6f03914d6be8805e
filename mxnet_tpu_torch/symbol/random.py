"""``mx.sym.random``: sampling nodes (reference: python/mxnet/symbol/
random.py; the JAX package's ``symbol/random.py``).  A node with no input
draws on the executor's device from the port's generator of that device,
a new draw at each run."""

from .symbol import _create

__all__ = ["uniform", "normal"]


def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", **kwargs):
    """Samples of U[low, high)."""
    return _create("_random_uniform", [], {"low": low, "high": high,
                                           "shape": shape, "dtype": dtype},
                   name=kwargs.get("name"))


def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", **kwargs):
    """Samples of N(loc, scale^2)."""
    return _create("_random_normal", [], {"loc": loc, "scale": scale,
                                          "shape": shape, "dtype": dtype},
                   name=kwargs.get("name"))
