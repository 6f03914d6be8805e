"""Training step of the PyTorch port built from a Gluon block.

Counterpart of ``mxnet_tpu/parallel/gluon_step.py`` ``GluonTrainStep``
(its classic path, on one device) and ``sgd_momentum_update``.  The JAX
package traces forward, loss, backward, the update and the BatchNorm
running-stat update into one program over a device mesh; the port runs
the same step eagerly on one device:

1. with ``compute_dtype`` set, the float32 trainables and the input are
   cast to it (``.to``, differentiable); the running statistics
   (``grad_req='null'``) stay float32;
2. forward through :func:`torch.func.functional_call` on the cast
   copies, in train mode, then the loss's mean over the batch;
3. the gradients of the float32 masters, through the casts: a bf16
   gradient is rounded to bf16 and widened to float32, as the JAX
   package's ``g.astype(v.dtype)``;
4. ``g += wd * w; s = momentum * s + g; w -= lr * s`` on every trainable,
   in place;
5. the running statistics, updated in place by the BatchNorm layers
   during the forward.

The float32 masters stay the block's own Parameters, so
:meth:`GluonTrainStep.sync_to_params` has nothing to do.  ``make_chained``
(as CUDA-graph replay), ``zero=True``, ``optimizer=`` and
``param_spec_fn`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import autograd as _autograd
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["GluonTrainStep", "sgd_momentum_update"]


def sgd_momentum_update(lr, momentum=0.9, wd=0.0):
    """SGD with momentum and weight decay on lists of float32 tensors, in
    place (``src/operator/optimizer_op.cc`` sgd_mom_update): ``g = g +
    wd * w``, ``s = momentum * s + g``, ``w = w - lr * s``, each product
    rounded before its sum as in the JAX package."""

    def update(weights, grads, states):
        g = torch._foreach_add(grads, torch._foreach_mul(weights, wd))
        torch._foreach_mul_(states, momentum)
        torch._foreach_add_(states, g)
        torch._foreach_sub_(weights, torch._foreach_mul(states, lr))

    return update


def _dtype(name):
    if name is None or isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise MXNetError("compute_dtype %r is not a floating type" % (name,))
    return dt


class GluonTrainStep:
    """A Gluon block, a loss and SGD with momentum as one training step.

    ``device``: where the block's parameters lie and the step runs
    (``None``: ``gpu(0)``).  ``compute_dtype`` (``'bfloat16'``, ...): the
    forward and backward run on cast copies of the float32 trainables and
    of the input, while the masters and their update stay float32.
    ``step(x, y)`` takes host arrays or tensors and returns the batch's
    mean loss as a tensor on the device, without waiting for it."""

    def __init__(self, block, loss_block, device=None, lr=0.1, momentum=0.9,
                 wd=0.0, compute_dtype=None):
        self.block = block
        self.device = resolve_device(device)
        params = block.collect_params()
        for name, p in params.items():
            if p.device != self.device:
                raise MXNetError("parameter %s lives on %s, not on the "
                                 "step's device %s" % (name, p.device,
                                                       self.device))
        self._names = [n for n, p in params.items() if p.grad_req != "null"]
        self.trainable = [params[n] for n in self._names]
        self.aux = [p for p in params.values() if p.grad_req == "null"]
        self.opt_state = [torch.zeros_like(p) for p in self.trainable]
        self._loss = loss_block
        self._update = sgd_momentum_update(lr, momentum, wd)
        self._compute_dtype = _dtype(compute_dtype)
        self.last_grad_norm = None

    def put_batch(self, x, y):
        """The batch as tensors on the step's device."""

        def put(v):
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            return v.to(self.device)

        return put(x), put(y)

    def __call__(self, x, y):
        """One training step; returns the mean loss (a device tensor in
        the compute dtype, not synchronised).  ``last_grad_norm`` becomes
        the global L2 norm of the float32 gradients."""
        x, y = self.put_batch(x, y)
        cast = self._compute_dtype
        with _autograd.record():
            override = {}
            if cast is not None:
                override = {n: p.to(cast) for n, p in zip(self._names,
                                                          self.trainable)
                            if p.dtype == torch.float32}
                x = x.to(cast)
            out = torch.func.functional_call(self.block, override, (x,))
            loss = self._loss(out, y).mean()
        grads = torch.autograd.grad(loss, self.trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.trainable, grads)]
        with torch.no_grad():
            self.last_grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            self._update(self.trainable, grads, self.opt_state)
        return loss.detach()

    def sync_to_params(self):
        """Nothing to do: the step updates the block's own Parameters in
        place (the JAX step keeps functional copies and writes them
        back here)."""
