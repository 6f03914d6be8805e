"""Neural-network ops of the PyTorch port, as plain functions on tensors.

Counterparts of ``mxnet_tpu/ops/nn.py`` FullyConnected, LeakyReLU (gelu),
LayerNorm, Dropout and log_softmax.  The JAX package leaves these to XLA;
here they stay plain PyTorch (the matrix products go to cuBLAS).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random

__all__ = ["fully_connected", "leaky_relu", "layer_norm", "dropout",
           "log_softmax"]


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
    """Dropout (reference: src/operator/nn/dropout.cc); the identity
    unless ``training`` (inference never drops).

    In training, a Bernoulli keep mask of rate ``1 - p``, scaled by
    ``1 / (1 - p)``, drawn from the port's generator of ``data``'s device
    (:func:`~mxnet_tpu_torch.random.generator`)."""
    if not training or p <= 0:
        return data
    keep = 1.0 - p
    prob = torch.full(data.shape, keep, dtype=torch.float32,
                      device=data.device)
    mask = torch.bernoulli(prob, generator=_random.generator(data.device))
    return data * (mask.to(data.dtype) / keep)


def log_softmax(data, axis=-1):
    """``log(softmax(data))`` along ``axis``, computed stably (reference:
    src/operator/nn/softmax.cc)."""
    return torch.log_softmax(data, dim=axis)
