"""Shape and indexing ops of the PyTorch port.

Counterparts of ``mxnet_tpu/ops/matrix.py`` Reshape, transpose,
slice_axis, Embedding and pick, and of ``mxnet_tpu/ops/contrib.py``
arange_like.
"""

from __future__ import annotations

import torch

__all__ = ["reshape", "transpose", "slice_axis", "embedding", "arange_like",
           "pick"]


def reshape(data, shape):
    """Reshape with the reference's special values ``0`` (keep this input
    dimension) and ``-1`` (infer one dimension)."""
    out = []
    for i, s in enumerate(shape):
        if s == 0:
            out.append(data.shape[i])
        elif s >= -1:
            out.append(s)
        else:
            raise ValueError("reshape code %d is not supported" % s)
    return data.reshape(out)


def transpose(data, axes):
    """Permute axes."""
    return data.permute(tuple(axes))


def slice_axis(data, axis, begin, end):
    """``data[begin:end]`` along ``axis``."""
    return data.narrow(axis, begin, end - begin)


def embedding(data, weight):
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


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
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
