"""Optimizer update ops of the PyTorch port.

Counterparts of ``mxnet_tpu/ops/optimizer_ops.py`` sgd_update,
sgd_mom_update and adam_update (reference: src/operator/optimizer_op.cc),
with MXNet's formulas, not ``torch.optim``'s: the gradient is rescaled,
then clipped, then gets ``wd * weight`` added (L2, not decoupled decay).
The JAX package returns new arrays and leaves the update to XLA; here
each op updates its weight and states in place, under
``torch.no_grad()``, as plain PyTorch, and returns them.
"""

from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """``w -= lr * (clip(rescale * g) + wd * w)``."""
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    weight.sub_(lr * g)
    return weight


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``m = momentum * m - lr * g; w += m`` (``torch.optim.SGD`` keeps
    ``v = momentum * v + g; w -= lr * v``, which differs once lr
    changes)."""
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    mom.mul_(momentum).sub_(lr * g)
    weight.add_(mom)
    return weight, mom


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Adam with ``epsilon`` outside the root; the bias correction is
    folded into ``lr`` by the optimizer, as in the reference."""
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    mean.mul_(beta1).add_((1.0 - beta1) * g)
    var.mul_(beta2).add_((1.0 - beta2) * g.square())
    weight.sub_(lr * mean / (var.sqrt() + epsilon))
    return weight, mean, var
