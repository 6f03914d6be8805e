"""Gluon utilities of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference:
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load``,
``clip_global_norm`` and ``check_sha1``, on tensors.  ``download`` is not
ported: the port reads its data from local files.
"""

from __future__ import annotations

import hashlib
import warnings

import numpy as np
import torch

from ..context import resolve_device

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` views along ``batch_axis``, the
    last one taking the remainder; with ``even_split`` a batch that does
    not divide raises ``ValueError``."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's a multiple of the number of "
            "devices, or set even_split=False."
            % (tuple(data.shape), num_slice, batch_axis))
    step = size // num_slice
    if not even_split and size < num_slice:
        step, num_slice = 1, size
    return [data.narrow(batch_axis, i * step,
                        (size if i == num_slice - 1 else (i + 1) * step)
                        - i * step)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch and copy each slice to one device of ``ctx_list``.
    A source that is not a tensor becomes one on the first device (a
    float64 array as float32, as ``nd.array`` makes it)."""
    if not isinstance(data, torch.Tensor):
        arr = np.asarray(data)
        if arr.dtype == np.float64 or not isinstance(data, np.ndarray):
            arr = arr.astype(np.float32)
        data = torch.from_numpy(np.ascontiguousarray(arr)).to(
            resolve_device(ctx_list[0]))
    if len(ctx_list) == 1:
        return [data.to(resolve_device(ctx_list[0]))]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.to(resolve_device(c)) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns that norm before the rescale.

    The norm (summed in float32) and its finite flag are one device
    computation and one read to the host, the only sync.  The arrays are
    rescaled by ``max_norm / (norm + 1e-8)`` only when the norm is finite
    and above ``max_norm``; a NaN or infinite norm leaves them as they
    are and, with ``check_isfinite``, warns (the JAX package's
    contract)."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(arrays, 2, dtype=torch.float32)))
    total_norm, finite = torch.stack(
        [norm, torch.isfinite(norm).to(norm.dtype)]).tolist()
    if check_isfinite and not finite:
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    if finite and total_norm > max_norm:
        torch._foreach_mul_(arrays, max_norm / (norm + 1e-8))
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the SHA-1 of the file ``filename`` is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The file ``url`` names, where it already lies (``path``, a file or a
    directory, default the working directory), unless ``overwrite`` or a
    SHA-1 mismatch asks for a new copy; never fetches: otherwise raises
    ``RuntimeError`` naming where to place the file (the JAX package's
    ``gluon/utils.py:129``)."""
    import os

    del retries, verify_ssl
    fname = path if path and not os.path.isdir(path) else \
        os.path.join(path or ".", url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise RuntimeError(
        "download(%s): this package does not fetch files; place the file "
        "at %s" % (url, fname))
