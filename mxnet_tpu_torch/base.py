"""Shared plumbing of the PyTorch port: the framework error type and dtypes.

Counterpart of ``mxnet_tpu/base.py`` (reference: python/mxnet/base.py).
Only the parts the port uses live here.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "numeric_types", "torch_dtype", "np_dtype",
           "saturating_cast"]

numeric_types = (float, int, np.generic)


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py MXNetError)."""


_NP_TO_TORCH = {np.dtype(k): v for k, v in (
    (np.float32, torch.float32), (np.float64, torch.float64),
    (np.float16, torch.float16), (np.uint8, torch.uint8),
    (np.uint32, torch.uint32),
    (np.int8, torch.int8), (np.int16, torch.int16),
    (np.int32, torch.int32), (np.int64, torch.int64),
    (np.bool_, torch.bool))}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dtype):
    """A dtype-ish (None for float32, a name such as ``"bfloat16"``, a
    numpy dtype or type, a ``torch.dtype``) as a ``torch.dtype``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (KeyError, TypeError) as e:
        raise MXNetError("dtype %r is not supported by the port" % (dtype,)) \
            from e


def np_dtype(dtype):
    """The numpy dtype of a ``torch.dtype`` (or dtype-ish); bfloat16, which
    numpy lacks, stays ``torch.bfloat16``."""
    dt = torch_dtype(dtype)
    return _TORCH_TO_NP.get(dt, dt)



def saturating_cast(t, dtype):
    """``t`` converted to ``dtype`` as the JAX package converts
    (``lax.convert_element_type``): a float becomes an integer by
    truncation, saturated at the integer type's limits, and NaN becomes
    0, on every device (a plain ``Tensor.to`` wraps out-of-range values on
    the CPU).  Other conversions are ``Tensor.to``'s."""
    if not t.is_floating_point() or dtype.is_floating_point \
            or dtype in (torch.bool, torch.complex64, torch.complex128):
        return t.to(dtype)
    info = torch.iinfo(dtype)
    # the limits compare in t's type: a float32 2**31 - 1 rounds up to
    # 2**31, the first value that overflows int32
    top, bottom = t >= info.max, t <= info.min
    safe = torch.where(top | bottom | torch.isnan(t), 0, t).to(dtype)
    return torch.where(top, info.max, torch.where(bottom, info.min, safe))
