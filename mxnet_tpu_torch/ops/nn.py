"""Neural-network ops of the PyTorch port, as plain functions on tensors.

Counterparts of ``mxnet_tpu/ops/nn.py`` FullyConnected, LeakyReLU (gelu),
LayerNorm and Dropout.  The JAX package leaves these to XLA;
here they stay plain PyTorch (the matrix products go to cuBLAS).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "leaky_relu", "layer_norm", "dropout"]


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias`` (reference: fully_connected.cc:239);
    ``flatten`` folds every axis after the first into one."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    return F.linear(x, weight, bias)


def leaky_relu(data, act_type="gelu"):
    """The LeakyReLU family member the port serves: ``gelu``, exact
    through erf as ``jax.nn.gelu(approximate=False)``."""
    if act_type != "gelu":
        raise ValueError("act_type %r is not ported yet" % act_type)
    return F.gelu(data, approximate="none")


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization over ``axis`` with the biased variance and
    ``eps`` inside the root (reference: src/operator/nn/layer_norm.cc)."""
    mean = data.mean(dim=axis, keepdim=True)
    var = (data - mean).square().mean(dim=axis, keepdim=True)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


def dropout(data, p=0.5, training=False):
    """Dropout; the identity unless ``training`` (inference never drops)."""
    if not training or p == 0:
        return data
    return F.dropout(data, p=p, training=True)
