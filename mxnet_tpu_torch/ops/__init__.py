"""Ops of the PyTorch port: plain functions on tensors, and the wrappers
of the hand-written kernels."""

from . import attention, conv_dw, matrix, nn, optimizer_ops, pool_bwd

__all__ = ["attention", "conv_dw", "matrix", "nn", "optimizer_ops",
           "pool_bwd"]
