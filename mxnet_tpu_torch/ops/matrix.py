"""Shape, product, ordering and indexing ops of the PyTorch port.

Counterparts of ``mxnet_tpu/ops/matrix.py`` (reference: matrix_op.cc,
dot.cc, ordering_op.cc, indexing_op.cc) under the same names, and of
``mxnet_tpu/ops/contrib.py`` arange_like.  Every op returns a new array,
as in the JAX package; only ``NDArray``'s basic indexing gives views.

Where torch and the JAX package could differ, the JAX package decides:
``sort``/``argsort`` are stable and a descending order is the ascending
one reversed; ``topk`` breaks ties toward the lower index; ``take`` and
``one_hot`` truncate float indices toward zero, ``take`` clips (or wraps)
out-of-range ones and ``one_hot`` gives a row of zeros for them; indices
are brought into range before any gather, since on CUDA an index out of
range is a device-side assert.

Not ported yet: ``linalg_*``, ``Sequence*``, ``gather_nd``/``scatter_nd``,
``index_*``, ``Crop``, ``Pad``, ``space_to_depth``/``depth_to_space`` and
the other ops of the JAX module.
"""

from __future__ import annotations

import builtins

import torch

from ..base import torch_dtype
from .registry import register

__all__ = ["reshape", "transpose", "swapaxes", "slice_axis", "embedding", "arange_like",
           "pick", "encode_basic_index", "decode_basic_index"]


# ------------------------------------------------------------ reshape etc.


@register("Reshape", aliases=("reshape",))
def reshape(data, shape=(), reverse=False, **_):
    """MXNet reshape with the special codes 0 (copy this dimension), -1
    (infer), -2 (copy the rest), -3 (merge two dimensions) and -4 (split
    one into the next two codes); ``reverse`` reads both shapes from the
    right."""
    src = list(data.shape[::-1]) if reverse else list(data.shape)
    tgt_spec = list(shape[::-1]) if reverse else list(shape)
    out = []
    src_i = 0
    i = 0
    while i < len(tgt_spec):
        s = tgt_spec[i]
        if s == 0:
            out.append(src[src_i])
            src_i += 1
        elif s == -1:
            out.append(-1)
            src_i += 1
        elif s == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif s == -3:
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif s == -4:
            d1, d2 = tgt_spec[i + 1], tgt_spec[i + 2]
            if d1 == -1:
                d1 = src[src_i] // d2
            if d2 == -1:
                d2 = src[src_i] // d1
            out.extend([d1, d2])
            src_i += 1
            i += 2
        else:
            out.append(s)
            src_i += 1
        i += 1
    if reverse:
        out = out[::-1]
    return data.reshape(tuple(out))


@register("reshape_like")
def reshape_like(x, y, **_):
    """``x`` in ``y``'s shape."""
    return x.reshape(y.shape)


@register("Flatten", aliases=("flatten",))
def flatten(x, **_):
    """``(N, ...) -> (N, -1)``."""
    return x.reshape((x.shape[0], -1))


@register("transpose")
def transpose(data, axes=(), **_):
    """Permute axes; empty ``axes`` reverses them."""
    if not axes:
        axes = tuple(range(data.dim()))[::-1]
    return data.permute(tuple(axes))


@register("SwapAxis", aliases=("swapaxes", "swapaxis"))
def swapaxes(data, dim1=0, dim2=0, **_):
    """Exchange axes ``dim1`` and ``dim2`` (reference:
    src/operator/swapaxis.cc)."""
    return data.transpose(int(dim1), int(dim2)).contiguous()


@register("expand_dims")
def expand_dims(x, axis=0, **_):
    """Insert a size-1 dimension at ``axis``."""
    return x.unsqueeze(int(axis))


@register("squeeze")
def squeeze(x, axis=None, **_):
    """Drop size-1 dimensions: all of them, or those of ``axis``."""
    if axis is None:
        return x.squeeze()
    return x.squeeze(tuple(axis) if isinstance(axis, tuple) else int(axis))


def _tensors(args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        return tuple(args[0])
    return args


@register("Concat", aliases=("concat",))
def concat(*args, dim=1, **_):
    """Concatenate along ``dim`` (default 1, the channel axis)."""
    return torch.cat(_tensors(args), dim=int(dim))


@register("stack")
def stack(*args, axis=0, **_):
    """Stack along a new ``axis``."""
    return torch.stack(_tensors(args), dim=int(axis))


def _split_nout(attrs):
    return int(attrs.get("num_outputs", 1))


@register("SliceChannel", aliases=("split",), num_outputs=_split_nout)
def split(x, num_outputs=1, axis=1, squeeze_axis=False, **_):
    """Split into ``num_outputs`` equal parts along ``axis``;
    ``squeeze_axis`` drops the split axis from each part."""
    n, ax = int(num_outputs), int(axis)
    if x.shape[ax] % n:
        raise ValueError("axis %d of size %d does not split into %d equal "
                         "parts" % (ax, x.shape[ax], n))
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


def _slice_dim(x, dim, start, stop, step):
    """``x[..., start:stop:step, ...]`` along ``dim`` with Python's rules,
    a negative step included (torch's slices take only positive ones)."""
    step = 1 if step in (None, 0) else int(step)
    lo, hi, st = builtins.slice(start, stop, step).indices(x.shape[dim])
    if st > 0:
        idx = [builtins.slice(None)] * x.dim()
        idx[dim] = builtins.slice(lo, hi, st)
        return x[tuple(idx)]
    return x.index_select(dim, torch.arange(lo, hi, st, device=x.device))


@register("slice", aliases=("crop",))
def slice_op(x, begin=(), end=(), step=(), **_):
    """N-D strided slice: per-axis ``begin``/``end``/``step`` (None
    entries take the whole extent; axes past them are left whole)."""
    out = x
    for d in range(x.dim()):
        b = begin[d] if d < len(begin) else None
        e = end[d] if d < len(end) else None
        s = step[d] if step and d < len(step) else None
        if (b, e, s) != (None, None, None):
            out = _slice_dim(out, d, b, e, s)
    return out


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None, **_):
    """``[begin, end)`` along one axis (``end=None``: to its end)."""
    return _slice_dim(data, int(axis) % data.dim(), begin, end, 1)


@register("tile")
def tile(x, reps=(), **_):
    """Repeat the whole array ``reps[i]`` times along each axis."""
    return torch.tile(x, tuple(reps))


@register("repeat")
def repeat(x, repeats=1, axis=None, **_):
    """Repeat each element ``repeats`` times along ``axis`` (None
    flattens first)."""
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), int(repeats))
    return torch.repeat_interleave(x, int(repeats), dim=int(axis))


@register("reverse", aliases=("flip",))
def reverse(x, axis=(), **_):
    """Reverse the order of elements along ``axis`` (an int or a tuple)."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, axes)


# ---------------------------------------------------------------- products


def promote(a, b):
    """``a`` and ``b`` in their common type (``torch.promote_types``), as
    ``jnp`` promotes the operands of a product."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


@register("dot")
def dot(a, b, transpose_a=False, transpose_b=False, **_):
    """MXNet dot: contracts the last axis of ``a`` with the first of ``b``
    (after a full transpose of either, if asked); two vectors give their
    inner product.  Operands of two types are promoted first
    (:func:`promote`)."""
    a, b = promote(a, b)
    if transpose_a:
        a = a.permute(tuple(range(a.dim()))[::-1])
    if transpose_b:
        b = b.permute(tuple(range(b.dim()))[::-1])
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(a, b, transpose_a=False, transpose_b=False, **_):
    """Batched product of the trailing two axes, of operands promoted to
    their common type (:func:`promote`)."""
    a, b = promote(a, b)
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


# ---------------------------------------------------------------- ordering


@register("sort")
def sort(x, axis=-1, is_ascend=True, **_):
    """Sorted values along ``axis`` (None flattens first)."""
    ax = 0 if axis is None else int(axis)
    xx = x.reshape(-1) if axis is None else x
    out = torch.sort(xx, dim=ax, stable=True).values
    return out if is_ascend else torch.flip(out, (ax,))


@register("argsort")
def argsort(x, axis=-1, is_ascend=True, dtype="float32", **_):
    """Indices that sort ``x`` along ``axis`` (stable; descending is the
    ascending order reversed), in ``dtype``."""
    ax = 0 if axis is None else int(axis)
    xx = x.reshape(-1) if axis is None else x
    idx = torch.argsort(xx, dim=ax, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, (ax,))
    return idx.to(torch_dtype(dtype))


def _topk_nout(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_nout)
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32", **_):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, ties to
    the lower index; ``ret_typ`` is ``value``, ``indices``, ``mask`` (0/1
    at the chosen places) or ``both``; ``k <= 0`` takes the whole axis."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    axis = int(axis) % x.dim()
    k = int(k) if int(k) > 0 else x.shape[axis]
    srt = torch.sort(x, dim=axis, descending=not is_ascend, stable=True)
    vals = srt.values.narrow(axis, 0, k)
    idx = srt.indices.narrow(axis, 0, k)
    if ret_typ == "value":
        return vals
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idx, 1)
    idxf = idx.to(torch_dtype(dtype))
    if ret_typ == "both":
        return vals, idxf
    return idxf


# ---------------------------------------------------------------- indexing


def _int_index(t):
    """Indices as int64, floats truncated toward zero (NaN to 0)."""
    if t.is_floating_point():
        t = torch.nan_to_num(torch.trunc(t), nan=0.0)
    return t.to(torch.int64)


@register("take")
def take(a, indices, axis=0, mode="clip", **_):
    """Slices of ``a`` at ``indices`` along ``axis``: out-of-range indices
    are clipped (``clip``, and ``raise``, which cannot raise on a device)
    or wrapped (``wrap``)."""
    if mode not in ("clip", "wrap", "raise"):
        raise ValueError("take mode must be clip, wrap or raise, not %r"
                         % (mode,))
    ax = int(axis) % a.dim()
    n = a.shape[ax]
    idx = _int_index(indices)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register("one_hot")
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32",
            **_):
    """``indices`` one-hot in a new trailing axis of ``depth``; an index
    outside ``[0, depth)`` gives a row of ``off_value``."""
    idx = _int_index(indices).unsqueeze(-1)
    oh = (idx == torch.arange(int(depth), device=idx.device)).float()
    return (oh * (on_value - off_value) + off_value).to(torch_dtype(dtype))


@register("Embedding")
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False, **_):
    """Rows of ``weight`` at the ids in ``data`` (any numeric dtype).

    The JAX package's semantics (``jnp.take`` in fill mode after casting
    the ids to int32): an id is truncated toward zero, an id in
    ``[-V, V)`` wraps (``-1`` is row ``V-1``), and any other id, NaN or
    infinity gives a row of NaN.  Out-of-range ids are masked before the
    gather, so no index the gather cannot take ever reaches it (on CUDA
    that would be a device-side assert that poisons the context)."""
    v = weight.shape[0]
    t = torch.trunc(data) if data.is_floating_point() else data
    valid = (t >= -v) & (t < v)
    idx = torch.where(valid, t, torch.zeros_like(t)).to(torch.int64)
    idx = torch.where(idx < 0, idx + v, idx)
    out = weight[idx]
    nan = torch.full((), float("nan"), dtype=out.dtype, device=out.device)
    return torch.where(valid.unsqueeze(-1), out, nan)


def arange_like(data, axis):
    """``0, 1, ..., data.shape[axis] - 1`` in ``data``'s dtype."""
    return torch.arange(data.shape[axis], dtype=data.dtype,
                        device=data.device)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip", **_):
    """``data`` picked along ``axis`` at ``index`` (any numeric dtype,
    shaped as ``data`` without ``axis``), as the JAX package's ``pick``:
    an index is truncated toward zero, then clipped to ``[0, n-1]``
    (``mode="clip"``) or taken modulo ``n`` (``"wrap"``).  The index is
    brought into range before the gather (on CUDA an index out of range
    would be a device-side assert); a NaN index picks element 0."""
    if mode not in ("clip", "wrap"):
        raise ValueError("pick mode must be 'clip' or 'wrap', not %r" % mode)
    ax = axis % data.dim()
    n = data.shape[ax]
    t = torch.trunc(index) if index.is_floating_point() else index
    t = t.clamp(0, n - 1) if mode == "clip" else torch.remainder(t, n)
    if t.is_floating_point():
        t = torch.nan_to_num(t, nan=0.0)
    shape = [d for i, d in enumerate(data.shape) if i != ax]
    idx = t.to(torch.int64).reshape(shape).unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if keepdims else out.squeeze(ax)


# ----------------------------------------------------------- basic indexing


def encode_basic_index(key):
    """A basic index (ints, slices, None, Ellipsis) as a hashable attr of
    ``_basic_index``: slices become ``("s", start, stop, step)``."""
    out = []
    for it in key if isinstance(key, tuple) else (key,):
        if isinstance(it, builtins.slice):
            out.append(("s", it.start, it.stop, it.step))
        elif it is None:
            out.append(("n",))
        elif it is Ellipsis:
            out.append(("e",))
        else:
            out.append(("i", int(it)))
    return tuple(out)


def decode_basic_index(key):
    out = []
    for it in key:
        if it[0] == "s":
            out.append(builtins.slice(it[1], it[2], it[3]))
        elif it[0] == "n":
            out.append(None)
        elif it[0] == "e":
            out.append(Ellipsis)
        else:
            out.append(it[1])
    return tuple(out)


@register("_basic_index")
def basic_index(x, key=(), **_):
    """``x`` at a basic index encoded by :func:`encode_basic_index`; a
    slice with a negative step is taken as a copy (torch's slices take
    only positive steps)."""
    key = decode_basic_index(key)
    n_ell = x.dim() - sum(1 for k in key if k is not None
                          and k is not Ellipsis)
    plain, d = [], 0
    for k in key:
        if k is Ellipsis:
            plain.append(k)
            d += n_ell
        elif k is None:
            plain.append(k)
        elif isinstance(k, builtins.slice) and k.step is not None \
                and k.step < 0:
            # slicing an input axis keeps the axes' positions
            x = _slice_dim(x, d, k.start, k.stop, k.step)
            plain.append(builtins.slice(None))
            d += 1
        else:
            plain.append(k)
            d += 1
    return x[tuple(plain)]
