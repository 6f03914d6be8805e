"""Ops of the PyTorch port: plain functions on tensors, and the wrappers
of the hand-written kernels."""

from . import attention, matrix, nn, optimizer_ops

__all__ = ["attention", "matrix", "nn", "optimizer_ops"]
