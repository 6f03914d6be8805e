"""Optimizer update ops of the PyTorch port.

Counterparts of the dense updates of ``mxnet_tpu/ops/optimizer_ops.py``
(``:29-296``) and of the aggregated ``multi_*`` updates of
``mxnet_tpu/ops/extended.py:505-620`` (reference:
src/operator/optimizer_op.cc), with MXNet's formulas, not
``torch.optim``'s: the gradient is rescaled, then clipped, then gets
``wd * weight`` added (L2, not decoupled decay), except where an op says
otherwise.  The JAX package returns new arrays and leaves the update to
XLA; here each op updates its weight and states in place, under
``torch.no_grad()``, and returns the weight (the ``multi_*`` ops: the
weights), as MXNet's ``out=weight`` does.  They are registered under the
JAX names.

These are element-wise work that XLA fuses in the JAX package, with no
Pallas kernel behind them, so each is plain PyTorch in the JAX op's own
rounding order: every product and sum rounds where the JAX op's does.

The per-step scalars ``lr``, ``wd`` and ``t`` may each be a float or a
0-d float32 tensor on the weight's device, so that a captured update
reads them from a buffer the host refills (``optimizer.scalar_feed``).
Where the JAX op combines them with each other before they meet a tensor
(``t``'s powers, Signum's ``lr * wd_lh``) or divides by or into one
(FTRL, FTML, Adamax: PyTorch divides by a float, and a float by a tensor,
through a reciprocal), a float is first made a 0-d float32 tensor
(:func:`_f32`), so the float and the fed tensor give the same bits.  The
row-sparse ``_sparse_*`` updates wait for sparse NDArrays.
"""

from __future__ import annotations

import torch

from .. import autograd as _autograd
from ..base import MXNetError
from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "nag_mom_update", "adam_update",
           "adamw_update", "rmsprop_update", "rmspropalex_update",
           "adagrad_update", "adadelta_update", "signsgd_update",
           "signum_update", "ftrl_update", "ftml_update", "adamax_update",
           "nadam_update", "mp_sgd_update", "mp_sgd_mom_update",
           "multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
           "multi_mp_sgd_mom_update"]


def _check_not_recorded(op, *states):
    """An update in place of an array in a recorded graph would corrupt
    it: refused while recording, as every in-place NDArray write."""
    if _autograd.is_recording() and any(t.requires_grad for t in states):
        raise MXNetError("%s: in-place update of an array that requires "
                         "grad while autograd is recording" % op)


def _f32(v, ref):
    """``v`` as a 0-d float32 tensor on ``ref``'s device (a tensor is
    taken as it is): scalar arithmetic then rounds as the JAX op's."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=torch.float32, device=ref.device)


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd):
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


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


@register("nag_mom_update")
@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **_):
    """Nesterov: ``m = momentum * m + g; w -= lr * (g + momentum * m)``."""
    _check_not_recorded("nag_mom_update", weight, mom)
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    mom.mul_(momentum).add_(g)
    weight.sub_(lr * (g + momentum * mom))
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


@register("adamw_update")
@torch.no_grad()
def adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0, **_):
    """AdamW (reference: src/operator/contrib/adamw.cc): the decay is
    decoupled, ``w -= eta * (lr * m / (sqrt(v) + eps) + wd * w)``."""
    _check_not_recorded("adamw_update", weight, mean, var)
    g = _clip(grad * rescale_grad, clip_gradient)
    mean.mul_(beta1).add_((1.0 - beta1) * g)
    var.mul_(beta2).add_((1.0 - beta2) * g.square())
    weight.sub_(eta * (lr * mean / (var.sqrt() + epsilon) + wd * weight))
    return weight


@register("rmsprop_update")
@torch.no_grad()
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0, **_):
    """RMSProp (Tieleman and Hinton): ``n = (1 - gamma1) g^2 + gamma1 n;
    w -= lr * g / sqrt(n + eps)``, then ``w`` clipped to
    ``clip_weights`` when it is positive."""
    _check_not_recorded("rmsprop_update", weight, n)
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    n.copy_((1.0 - gamma1) * g.square() + gamma1 * n)
    weight.sub_(lr * g / (n + epsilon).sqrt())
    if clip_weights is not None and clip_weights > 0:
        weight.clamp_(-clip_weights, clip_weights)
    return weight


@register("rmspropalex_update")
@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0, **_):
    """Centered RMSProp (Graves 2013): the variance estimate is
    ``n - g_state^2``, the step a momentum ``delta``."""
    _check_not_recorded("rmspropalex_update", weight, n, g_state, delta)
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    n.copy_((1.0 - gamma1) * g.square() + gamma1 * n)
    g_state.copy_((1.0 - gamma1) * g + gamma1 * g_state)
    delta.copy_(gamma2 * delta - lr * g
                / (n - g_state.square() + epsilon).sqrt())
    weight.add_(delta)
    return weight


@register("adagrad_update")
@torch.no_grad()
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **_):
    """AdaGrad over the dense history: ``h += g^2; w -= lr * g / (sqrt(h)
    + eps)``."""
    _check_not_recorded("adagrad_update", weight, history)
    g = _apply_wd_rescale(weight, grad, rescale_grad, clip_gradient, wd)
    history.add_(g.square())
    weight.sub_(lr * g / (history.sqrt() + epsilon))
    return weight


@register("adadelta_update")
@torch.no_grad()
def adadelta_update(weight, grad, acc_g, acc_delta, lr=0.01, rho=0.9,
                    epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, **_):
    """AdaDelta (Zeiler 2012): no ``lr`` in the step (taken and unused,
    as in the reference); ``wd`` decays the weight directly."""
    _check_not_recorded("adadelta_update", weight, acc_g, acc_delta)
    g = _clip(grad * rescale_grad, clip_gradient)
    acc_g.copy_(rho * acc_g + (1.0 - rho) * g.square())
    d = (acc_delta + epsilon).sqrt() / (acc_g + epsilon).sqrt() * g
    acc_delta.copy_(rho * acc_delta + (1.0 - rho) * d.square())
    weight.copy_(weight - d - wd * weight)
    return weight


@register("signsgd_update")
@torch.no_grad()
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **_):
    """SignSGD: ``w -= lr * (sign(g) + wd * w)``."""
    _check_not_recorded("signsgd_update", weight)
    g = _clip(grad * rescale_grad, clip_gradient)
    weight.sub_(lr * (g.sign() + wd * weight))
    return weight


@register("signum_update")
@torch.no_grad()
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **_):
    """Signum: ``m = momentum * m - (1 - momentum) (g + wd w); w = (1 -
    lr * wd_lh) w + lr * sign(m)``."""
    _check_not_recorded("signum_update", weight, mom)
    g = _clip(grad * rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - (1.0 - momentum) * (g + wd * weight))
    weight.copy_((1.0 - _f32(lr, weight) * wd_lh) * weight
                 + lr * mom.sign())
    return weight


@register("ftrl_update")
@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, **_):
    """FTRL-proximal with L1 shrinkage: a weight inside the ``lamda1``
    ball is exactly 0."""
    _check_not_recorded("ftrl_update", weight, z, n)
    g = _clip(grad * rescale_grad, clip_gradient)
    lr = _f32(lr, weight)
    new_n = n + g.square()
    sigma = (new_n.sqrt() - n.sqrt()) / lr
    z.copy_(z + g - sigma * weight)
    n.copy_(new_n)
    weight.copy_(torch.where(
        z.abs() > lamda1,
        -(z - z.sign() * lamda1) / ((beta + n.sqrt()) / lr + wd),
        torch.zeros((), dtype=weight.dtype, device=weight.device)))
    return weight


@register("ftml_update")
@torch.no_grad()
def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1,
                **_):
    """FTML (Zheng and Kwok 2017) over ``d, v, z``; the step count ``t``
    drives the bias corrections."""
    _check_not_recorded("ftml_update", weight, d, v, z)
    g = _clip(grad * rescale_grad + wd * weight, clip_grad)
    lr, t = _f32(lr, weight), _f32(t, weight)
    v.copy_(beta2 * v + (1.0 - beta2) * g.square())
    d_t = (1.0 - torch.pow(beta1, t)) / lr * (
        (v / (1.0 - torch.pow(beta2, t))).sqrt() + epsilon)
    sigma = d_t - beta1 * d
    z.copy_(beta1 * z + (1.0 - beta1) * g - sigma * weight)
    d.copy_(d_t)
    weight.copy_(-z / d_t)
    return weight


@register("adamax_update")
@torch.no_grad()
def adamax_update(weight, grad, m, u, lr=0.002, beta1=0.9, beta2=0.999,
                  wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, t=1, **_):
    """Adamax: ``m = beta1 m + (1 - beta1) g; u = max(beta2 u, |g|); w -=
    lr / (1 - beta1^t) * m / (u + 1e-8)``."""
    _check_not_recorded("adamax_update", weight, m, u)
    g = _clip(grad * rescale_grad + wd * weight, clip_gradient)
    lr_c = _f32(lr, weight) / (1.0 - torch.pow(beta1, _f32(t, weight)))
    m.copy_(beta1 * m + (1.0 - beta1) * g)
    u.copy_(torch.maximum(beta2 * u, g.abs()))
    weight.sub_(lr_c * m / (u + 1e-8))
    return weight


@register("nadam_update")
@torch.no_grad()
def nadam_update(weight, grad, m, v, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 t=1, m_schedule=1.0, momentum_t=0.9, momentum_t_1=0.9, **_):
    """Nadam; ``m_schedule`` is the product of the momentum schedule up
    to and including this step's ``momentum_t`` (the host keeps it)."""
    _check_not_recorded("nadam_update", weight, m, v)
    g = _clip(grad * rescale_grad + wd * weight, clip_gradient)
    t = _f32(t, weight)
    m_schedule_next = _f32(m_schedule, weight) * momentum_t_1
    m.copy_(beta1 * m + (1.0 - beta1) * g)
    v.copy_(beta2 * v + (1.0 - beta2) * g.square())
    g_prime = g / (1.0 - _f32(m_schedule, weight))
    m_prime = m / (1.0 - m_schedule_next)
    v_prime = v / (1.0 - torch.pow(beta2, t))
    m_bar = (1.0 - _f32(momentum_t, weight)) * g_prime \
        + momentum_t_1 * m_prime
    weight.sub_(lr * m_bar / (v_prime.sqrt() + epsilon))
    return weight


@register("mp_sgd_update")
@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, **_):
    """SGD on the float32 master ``weight32``; ``weight`` (float16 or
    bf16) becomes its rounding."""
    _check_not_recorded("mp_sgd_update", weight, weight32)
    g = _apply_wd_rescale(weight32, grad.float(), rescale_grad,
                          clip_gradient, wd)
    weight32.sub_(lr * g)
    weight.copy_(weight32)
    return weight


@register("mp_sgd_mom_update")
@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **_):
    """Momentum SGD on the float32 master and momentum; ``weight``
    becomes the master's rounding."""
    _check_not_recorded("mp_sgd_mom_update", weight, mom, weight32)
    g = _apply_wd_rescale(weight32, grad.float(), rescale_grad,
                          clip_gradient, wd)
    mom.mul_(momentum).sub_(lr * g)
    weight32.add_(mom)
    weight.copy_(weight32)
    return weight


def _num_weights(attrs):
    return int(attrs.get("num_weights", 1))


def _groups(args, n, size, op):
    if len(args) != n * size:
        raise MXNetError("%s: %d inputs for num_weights=%d; %d a weight"
                         % (op, len(args), n, size))
    return [args[size * i:size * (i + 1)] for i in range(n)]


def _weights(groups):
    return tuple(g[0] for g in groups) if len(groups) > 1 else groups[0][0]


@register("multi_sgd_update", num_outputs=_num_weights)
@torch.no_grad()
def multi_sgd_update(*args, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1, **_):
    """:func:`sgd_update` over ``num_weights`` (weight, grad) pairs, each
    with its own ``lrs[i]`` and ``wds[i]``."""
    groups = _groups(args, int(num_weights), 2, "multi_sgd_update")
    for (w, g), lr, wd in zip(groups, lrs, wds):
        _check_not_recorded("multi_sgd_update", w)
        w.sub_(lr * (_clip(g * rescale_grad, clip_gradient) + wd * w))
    return _weights(groups)


@register("multi_sgd_mom_update", num_outputs=_num_weights)
@torch.no_grad()
def multi_sgd_mom_update(*args, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0, num_weights=1,
                         **_):
    """:func:`sgd_mom_update` over ``num_weights`` (weight, grad, mom)
    triples."""
    groups = _groups(args, int(num_weights), 3, "multi_sgd_mom_update")
    for (w, g, m), lr, wd in zip(groups, lrs, wds):
        _check_not_recorded("multi_sgd_mom_update", w, m)
        m.copy_(momentum * m - lr * (_clip(g * rescale_grad, clip_gradient)
                                     + wd * w))
        w.add_(m)
    return _weights(groups)


@register("multi_mp_sgd_update", num_outputs=_num_weights)
@torch.no_grad()
def multi_mp_sgd_update(*args, lrs=(), wds=(), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1, **_):
    """:func:`mp_sgd_update` over ``num_weights`` (weight, grad,
    weight32) triples."""
    groups = _groups(args, int(num_weights), 3, "multi_mp_sgd_update")
    for (w, g, w32), lr, wd in zip(groups, lrs, wds):
        _check_not_recorded("multi_mp_sgd_update", w, w32)
        gf = _clip(g.float() * rescale_grad, clip_gradient)
        w32.sub_(lr * (gf + wd * w32))
        w.copy_(w32)
    return _weights(groups)


@register("multi_mp_sgd_mom_update", num_outputs=_num_weights)
@torch.no_grad()
def multi_mp_sgd_mom_update(*args, lrs=(), wds=(), momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1, **_):
    """:func:`mp_sgd_mom_update` over ``num_weights`` (weight, grad, mom,
    weight32) quads."""
    groups = _groups(args, int(num_weights), 4, "multi_mp_sgd_mom_update")
    for (w, g, m, w32), lr, wd in zip(groups, lrs, wds):
        _check_not_recorded("multi_mp_sgd_mom_update", w, m, w32)
        gf = _clip(g.float() * rescale_grad, clip_gradient)
        m.copy_(momentum * m - lr * (gf + wd * w32))
        w32.add_(m)
        w.copy_(w32)
    return _weights(groups)
