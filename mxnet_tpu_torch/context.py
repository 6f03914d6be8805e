"""Devices of the PyTorch port.

Counterpart of ``mxnet_tpu/context.py``.  A context here is a plain
``torch.device``: ``gpu(i)`` is ``cuda:i`` and ``cpu()`` is the host.

The default-device rule: every entry point (model constructors,
``initialize``, ``InferenceServer``) runs on ``gpu(0)`` unless the caller
passes a device.  With no CUDA device and no explicit device it raises
:class:`MXNetError`; it never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["gpu", "cpu", "resolve_device"]


def gpu(device_id=0):
    """The CUDA device ``device_id`` (reference: ``mx.gpu``)."""
    return torch.device("cuda", int(device_id))


def cpu():
    """The host (reference: ``mx.cpu``)."""
    return torch.device("cpu")


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means ``gpu(0)``.

    Raises :class:`MXNetError` when the device is a CUDA device and no
    CUDA device is present."""
    dev = gpu(0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the host" if device is None else
            "device %s requested but no CUDA device is available" % dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
