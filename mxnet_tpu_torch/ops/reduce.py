"""Reduction and broadcast-to ops of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/reduce.py`` (reference:
broadcast_reduce_op_value.cc and broadcast_reduce_op_index.cc), with
MXNet's ``axis`` (an int, a tuple or None for all), ``keepdims`` and
``exclude`` (reduce over every axis *not* listed).

The result types are the JAX package's: a sum or product (``sum``,
``prod``, ``nansum``, ``nanprod``, ``norm(ord=1)``) of signed integers or
booleans is int32 and of unsigned integers uint32, wrapping (int64 input,
which the JAX package never holds, stays int64); a mean of integers is
float32; ``cumsum`` keeps an integer type (booleans give int32);
``dtype=`` sets the accumulation type of sum, mean, prod, nansum and
nanprod; argmax/argmin return float32 indices.
"""

from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

__all__ = []


def _norm_axis(axis, ndim, exclude=False):
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _int_result(x):
    """The type of a sum or product of ``x`` with no ``dtype=``."""
    if x.dtype == torch.int64 or x.is_floating_point() or x.is_complex():
        return x.dtype
    return torch.uint32 if x.dtype in _UNSIGNED else torch.int32


def _wrapping(fn, x, dtype):
    """``fn`` of ``x`` in ``dtype``.  Integers are summed or multiplied in
    int64 and wrapped to ``dtype``, which is the same value modulo its
    range (torch widens integer sums and products to int64, and has no
    uint32 sum)."""
    if x.is_floating_point() or x.is_complex() or dtype is None \
            or dtype.is_floating_point or dtype == torch.int64:
        return fn(x if dtype is None else x.to(dtype))
    return fn(x.to(torch.int64)).to(dtype)


def _prod(x, axes, keepdims, dtype):
    def run(out):
        for a in sorted(axes, reverse=True):
            out = torch.prod(out, dim=a, keepdim=keepdims)
        return out

    return _wrapping(run, x, dtype)


_DTYPE_REDUCES = ("sum", "mean", "prod", "nansum", "nanprod")


def _reduce_fn(name):
    def run(x, axes, keepdims, dtype):
        if name == "sum":
            if x.is_floating_point() or x.is_complex():
                return torch.sum(x, dim=axes, keepdim=keepdims, dtype=dtype)
            return _wrapping(lambda t: torch.sum(t, dim=axes,
                                                 keepdim=keepdims),
                             x, dtype)
        if name == "nansum":
            return _wrapping(lambda t: torch.nansum(t, dim=axes,
                                                    keepdim=keepdims),
                             x, dtype)
        if name == "mean":
            if dtype is None and not x.is_floating_point():
                dtype = torch.float32
            return torch.mean(x if dtype is None else x.to(dtype), dim=axes,
                              keepdim=keepdims)
        if name == "prod":
            return _prod(x, axes, keepdims, dtype)
        if name == "nanprod":
            return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x)
                         if x.is_floating_point() else x, axes, keepdims,
                         dtype)
        if name == "max":
            return torch.amax(x, dim=axes, keepdim=keepdims)
        return torch.amin(x, dim=axes, keepdim=keepdims)

    return run


def _make_reduce(name):
    run = _reduce_fn(name)

    @register(name, aliases=("%s_axis" % name,))
    def _op(x, axis=None, keepdims=False, exclude=False, dtype=None, **_):
        """Reduce ``x`` over ``axis`` (int, tuple, or None for all axes);
        ``exclude`` reduces over every axis *not* listed, ``keepdims``
        keeps reduced axes as size 1; ``dtype`` is the accumulation type
        of the sum-like reductions."""
        axes = _norm_axis(axis, x.dim(), exclude)
        if not axes and x.dim():
            # no axis to reduce (``exclude`` of every axis): torch would
            # read an empty ``dim`` as all of them
            return x.to(torch_dtype(dtype)) if dtype is not None \
                else x.clone()
        if name in _DTYPE_REDUCES:
            if dtype is not None:
                dt = torch_dtype(dtype)
            elif name == "mean":
                dt = None
            else:
                dt = _int_result(x)
            out = run(x, axes, bool(keepdims), dt)
        else:
            out = run(x, axes, bool(keepdims), None)
        return out

    _op.__name__ = name
    return _op


for _name in ("sum", "mean", "prod", "max", "min", "nansum", "nanprod"):
    _make_reduce(_name)


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False, **_):
    """L1 (``ord=1``) or L2 norm of ``x`` over ``axis`` (None: all axes)."""
    axes = _norm_axis(axis, x.dim())
    if ord == 1:
        mag = x if x.dtype == torch.bool else torch.abs(x)
        return _wrapping(lambda t: torch.sum(t, dim=axes,
                                             keepdim=bool(keepdims)),
                         mag, _int_result(x))
    return torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                keepdim=bool(keepdims)))


def _index_reduce(name, tf):
    @register(name)
    def _op(x, axis=None, keepdims=False, **_):
        """Index of the first extremum along ``axis`` (None flattens
        first), as float32 indices; bools compare as 0 and 1."""
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        if axis is None:
            out = tf(x.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * x.dim())
            return out.to(torch.float32)
        out = tf(x, dim=int(axis), keepdim=bool(keepdims))
        return out.to(torch.float32)

    _op.__name__ = name
    return _op


_index_reduce("argmax", torch.argmax)
_index_reduce("argmin", torch.argmin)


@register("argmax_channel")
def argmax_channel(x, **_):
    """Argmax over axis 1, as float32 indices."""
    return torch.argmax(x, dim=1).to(torch.float32)


@register("broadcast_to")
def broadcast_to(x, shape=None, **_):
    """Broadcast ``x`` to ``shape``; a 0 in ``shape`` keeps that dimension."""
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, shape))
    return x.expand(tgt).contiguous()


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(x, axis=(), size=(), **_):
    """Broadcast the size-1 dimensions ``axis`` of ``x`` to ``size``."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return x.expand(tuple(tgt)).contiguous()


@register("broadcast_like")
def broadcast_like(x, y, lhs_axes=None, rhs_axes=None, **_):
    """Broadcast ``x`` to ``y``'s shape, or only the paired axes."""
    if lhs_axes is None:
        return x.expand(y.shape).contiguous()
    tgt = list(x.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = y.shape[ra]
    return x.expand(tuple(tgt)).contiguous()


@register("cumsum")
def cumsum(x, axis=None, dtype=None, **_):
    """Cumulative sum along ``axis`` (None flattens first), in ``dtype``
    (integers keep their type, booleans give int32, as the JAX
    package)."""
    if dtype is not None:
        d = torch_dtype(dtype)
    else:
        d = torch.int32 if x.dtype == torch.bool else x.dtype
    if axis is None:
        return torch.cumsum(x.reshape(-1), dim=0, dtype=d)
    return torch.cumsum(x, dim=int(axis), dtype=d)
