"""Array files of the PyTorch port.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` ``save`` / ``load`` /
``_parse_npz``: the same npz container with a ``__format__`` entry of
``"dict"`` or ``"list"``, so files written by either package (for
example ``HybridBlock.save_parameters``) load into the other.  Arrays
are ``torch.Tensor`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import resolve_device

__all__ = ["save", "load", "read_npz"]


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save(fname, data):
    """Write a tensor, a list of tensors or a dict of tensors to ``fname``
    (numpy arrays are accepted too).  The file name is used as given."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        arrays = {k: _to_numpy(v) for k, v in data.items()}
        fmt = "dict"
    elif isinstance(data, (list, tuple)):
        arrays = {"arr_%d" % i: _to_numpy(v) for i, v in enumerate(data)}
        fmt = "list"
    else:
        raise TypeError("save expects a tensor, list or dict")
    with open(fname, "wb") as f:
        np.savez(f, __format__=fmt, **arrays)


def _parse_npz(data):
    """Saved blob -> ``("list", [numpy...])`` or ``("dict", {name: numpy})``."""
    try:
        fmt = str(data["__format__"])
    except KeyError:
        fmt = "dict"
    if fmt == "list":
        n = len([k for k in data.files if k.startswith("arr_")])
        return "list", [data["arr_%d" % i] for i in range(n)]
    return "dict", {k: data[k] for k in data.files if k != "__format__"}


def read_npz(fname):
    """The arrays of a saved file as numpy, without placing them anywhere."""
    with np.load(fname, allow_pickle=False) as data:
        return _parse_npz(data)[1]


def load(fname, device=None):
    """Read a saved file into tensors on ``device`` (default ``gpu(0)``):
    a list or a dict, as it was saved."""
    dev = resolve_device(device)
    parsed = read_npz(fname)
    if isinstance(parsed, list):
        return [torch.from_numpy(v).to(dev) for v in parsed]
    return {k: torch.from_numpy(v).to(dev) for k, v in parsed.items()}
