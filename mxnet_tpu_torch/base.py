"""Shared plumbing of the PyTorch port: the framework error type.

Counterpart of ``mxnet_tpu/base.py`` (reference: python/mxnet/base.py).
Only the parts the port uses live here.
"""

from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py MXNetError)."""
