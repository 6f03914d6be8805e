"""Ops of the PyTorch port: plain functions on tensors, registered under
the JAX package's names (:mod:`.registry`), and the wrappers of the
hand-written kernels."""

from . import (attention, box_nms, contrib, conv_dw, custom, elemwise,
               init_ops, matrix, nn, optimizer_ops, pool_bwd, reduce,
               registry, rnn)

__all__ = ["attention", "box_nms", "contrib", "conv_dw", "custom",
           "elemwise", "init_ops", "matrix", "nn", "optimizer_ops",
           "pool_bwd", "reduce", "registry", "rnn"]
