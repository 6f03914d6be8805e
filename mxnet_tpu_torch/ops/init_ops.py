"""Creation ops and random samplers of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/init_ops.py`` (reference: init_op.cc,
src/operator/random/sample_op.cc, shuffle_op.cc).  An op with no tensor
input takes the device as the ``ctx`` attribute (``None``: ``gpu(0)``,
raising without a card, as every entry point of the port).  The random
ops draw from the port's generator of that device
(:func:`mxnet_tpu_torch.random.generator`), not from JAX's threefry keys:
the draws differ from the JAX package's, the laws are the same.

The other samplers of the JAX module (gamma, exponential, poisson,
negative binomial, multinomial, the ``_sample_*`` ops, unique zipfian)
are not ported yet.
"""

from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from .registry import register

__all__ = []


@register("_zeros", aliases=("zeros",))
def zeros(shape=(), dtype="float32", ctx=None, **_):
    """All-zeros array of ``shape``."""
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                       device=resolve_device(ctx))


@register("_ones", aliases=("ones",))
def ones(shape=(), dtype="float32", ctx=None, **_):
    """All-ones array of ``shape``."""
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype),
                      device=resolve_device(ctx))


@register("_full", aliases=("full",))
def full(shape=(), value=0.0, dtype="float32", ctx=None, **_):
    """Array of ``shape`` filled with ``value``."""
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=resolve_device(ctx))


@register("zeros_like")
def zeros_like(x, **_):
    """Zeros with the shape and dtype of ``x``."""
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(x, **_):
    """Ones with the shape and dtype of ``x``."""
    return torch.ones_like(x)


@register("_arange", aliases=("arange",))
def arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
           ctx=None, **_):
    """Evenly spaced values in ``[start, stop)`` (``stop=None``: in
    ``[0, start)``), each repeated ``repeat`` times."""
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=resolve_device(ctx))
    if repeat != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_linspace", aliases=("linspace",))
def linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
             ctx=None, **_):
    """``num`` evenly spaced values from ``start`` to ``stop``, which is
    included when ``endpoint``."""
    num = int(num)
    dev = resolve_device(ctx)
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=torch.float64,
                             device=dev)
    else:
        out = torch.linspace(start, stop, num + 1, dtype=torch.float64,
                             device=dev)[:num]
    return out.to(torch_dtype(dtype))


@register("_eye", aliases=("eye",))
def eye(N=1, M=0, k=0, dtype="float32", ctx=None, **_):
    """``(N, M)`` matrix (``M=0``: square) with ones on diagonal ``k``."""
    n = int(N)
    m = int(M) if M else n
    dev = resolve_device(ctx)
    rows = torch.arange(n, device=dev).unsqueeze(1)
    cols = torch.arange(m, device=dev).unsqueeze(0)
    return (cols - rows == int(k)).to(torch_dtype(dtype))


# ------------------------------------------------------------------ random


def _check_param(op, name, value, ok):
    """Reject an invalid scalar distribution parameter, as the JAX package
    does at dispatch."""
    if isinstance(value, (int, float)) and not ok(value):
        raise MXNetError("%s: invalid %s=%r" % (op, name, value))


@register("_random_uniform", aliases=("random_uniform", "uniform"))
def random_uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None,
                   **_):
    """Uniform samples over ``[low, high)`` of ``shape``."""
    dev = resolve_device(ctx)
    u = torch.rand(tuple(shape), generator=_random.generator(dev),
                   device=dev, dtype=torch.float32)
    return (u * (high - low) + low).to(torch_dtype(dtype))


@register("_random_normal", aliases=("random_normal", "normal"))
def random_normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None,
                  **_):
    """Gaussian samples with mean ``loc`` and standard deviation ``scale``."""
    _check_param("random_normal", "scale", scale, lambda v: v >= 0)
    dev = resolve_device(ctx)
    z = torch.randn(tuple(shape), generator=_random.generator(dev),
                    device=dev, dtype=torch.float32)
    return (z * scale + loc).to(torch_dtype(dtype))


@register("_random_randint", aliases=("random_randint", "randint"))
def random_randint(low=0, high=1, shape=(1,), dtype="int32", ctx=None, **_):
    """Uniform integers in ``[low, high)`` of ``shape``."""
    dev = resolve_device(ctx)
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=_random.generator(dev), device=dev,
                         dtype=torch_dtype(dtype))


@register("_shuffle", aliases=("shuffle",))
def shuffle(data, **_):
    """A random permutation of ``data`` along axis 0."""
    perm = torch.randperm(data.shape[0],
                          generator=_random.generator(data.device),
                          device=data.device)
    return data[perm]
