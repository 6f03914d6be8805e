"""Optimizer update ops of the PyTorch port.

Counterparts of ``mxnet_tpu/ops/optimizer_ops.py`` sgd_update,
sgd_mom_update and adam_update (reference: src/operator/optimizer_op.cc),
with MXNet's formulas, not ``torch.optim``'s: the gradient is rescaled,
then clipped, then gets ``wd * weight`` added (L2, not decoupled decay).
The JAX package returns new arrays and leaves the update to XLA; here
each op updates its weight and states in place, under
``torch.no_grad()``, as plain PyTorch, and returns the weight, as MXNet's
``out=weight`` does (the JAX ops return the new weight and states).  They
are registered under the JAX names.
"""

from __future__ import annotations

import torch

from .. import autograd as _autograd
from ..base import MXNetError
from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _check_not_recorded(op, *states):
    """An update in place of an array in a recorded graph would corrupt
    it: refused while recording, as every in-place NDArray write."""
    if _autograd.is_recording() and any(t.requires_grad for t in states):
        raise MXNetError("%s: in-place update of an array that requires "
                         "grad while autograd is recording" % op)


def _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight


@register("sgd_update")
@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=False, **_):
    """``w -= lr * (clip(rescale * g) + wd * w)``."""
    _check_not_recorded("sgd_update", weight)
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    weight.sub_(lr * g)
    return weight


@register("sgd_mom_update")
@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False,
                   **_):
    """``m = momentum * m - lr * g; w += m`` (``torch.optim.SGD`` keeps
    ``v = momentum * v + g; w -= lr * v``, which differs once lr
    changes)."""
    _check_not_recorded("sgd_mom_update", weight, mom)
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    mom.mul_(momentum).sub_(lr * g)
    weight.add_(mom)
    return weight


@register("adam_update")
@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False, **_):
    """Adam with ``epsilon`` outside the root; the bias correction is
    folded into ``lr`` by the optimizer, as in the reference."""
    _check_not_recorded("adam_update", weight, mean, var)
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    mean.mul_(beta1).add_((1.0 - beta1) * g)
    var.mul_(beta2).add_((1.0 - beta2) * g.square())
    weight.sub_(lr * mean / (var.sqrt() + epsilon))
    return weight
