"""Carry weights from the JAX package into the PyTorch port.

The port's attribute names are chosen so that its ``state_dict`` keys are
the JAX package's structural parameter names
(``Block._collect_params_with_prefix()``), and its Dense weights keep the
(out, in) layout.  So carrying weights is a checked copy by name.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .base import MXNetError
from .ndarray import read_npz

__all__ = ["load_mxnet_tpu_params"]


def load_mxnet_tpu_params(module, params):
    """Copy ``params`` into ``module``'s parameters.

    ``params``: a dict of structural name -> array (numpy, or anything
    ``numpy.asarray`` takes), or the path of a ``save_parameters`` npz file.
    Raises :class:`MXNetError` on any missing or extra name and on any
    shape mismatch, before anything is copied.  A deferred parameter
    (:class:`~mxnet_tpu_torch.gluon.block.DeferredParameter`) takes the
    array's shape where its known dimensions agree."""
    from .gluon.block import is_deferred, materialize

    if isinstance(params, (str, os.PathLike)):
        params = read_npz(params)
    if not isinstance(params, dict):
        raise MXNetError("params must be a dict or an npz path")
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError("parameter names differ: missing %s, extra %s"
                         % (missing, extra))
    arrays = {}
    for name, target in own.items():
        arr = np.asarray(params[name])
        if is_deferred(target):
            want = target.declared_shape
            fits = len(arr.shape) == len(want) and all(
                w in (0, a) for w, a in zip(want, arr.shape))
        else:
            want = tuple(target.shape)
            fits = tuple(arr.shape) == want
        if not fits:
            raise MXNetError("parameter %s: shape %s, expected %s"
                             % (name, arr.shape, want))
        arrays[name] = arr
    with torch.no_grad():
        for name, target in own.items():
            if is_deferred(target):
                materialize(target, arrays[name].shape)
            src = np.require(arrays[name], requirements=["C", "W"])
            target.copy_(torch.from_numpy(src))
    return module
