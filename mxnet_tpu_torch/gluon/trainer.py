"""Gluon Trainer of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py) on one device with no kvstore:
``allreduce_grads`` has nothing to reduce, and ``step(batch_size)`` sets
the optimizer's ``rescale_grad`` to ``1 / batch_size`` and updates every
parameter whose ``grad_req`` is not ``'null'`` from its ``.grad``.
"""

from __future__ import annotations

import torch

from .. import optimizer as _optimizer
from .block import Parameter

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of parameters.

    ``params``: a dict (``Block.collect_params()``) or a list of
    parameters; ``optimizer``: a registered name or an ``Optimizer``;
    ``optimizer_params``: its keyword arguments (for example
    ``{"learning_rate": 1e-3}``)."""

    def __init__(self, params, optimizer, optimizer_params=None):
        if isinstance(params, dict):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a list/dict of Parameters")
        self._params = []
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("invalid parameter %r" % (p,))
            self._params.append(p)
        optimizer_params = optimizer_params or {}
        if isinstance(optimizer, _optimizer.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be empty when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = _optimizer.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._scale = self._optimizer.rescale_grad
        self._updater = _optimizer.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients (nothing to do on one device) and update
        with ``rescale_grad = 1 / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """One device and no kvstore: the gradients are already whole."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Update without reducing, after :meth:`allreduce_grads`."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        del ignore_stale_grad  # as the JAX package: every grad is used
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            # a parameter no backward has reached yet has a zero gradient
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            self._updater(i, grad, p)
