"""Optimizers of the PyTorch port.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (reference:
python/mxnet/optimizer/optimizer.py): the registry (``register``,
``create``), the ``Optimizer`` base with ``lr``, ``wd``,
``rescale_grad``, ``clip_gradient``, per-parameter multipliers from
``param_dict`` and per-index update counts, ``SGD`` (with momentum),
``Adam``, and the ``Updater`` that keeps each index's state.  Updates run
the in-place ops of :mod:`~mxnet_tpu_torch.ops.optimizer_ops`; there is
no ``torch.optim`` underneath.
"""

from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "register", "create",
           "get_updater"]

_REGISTRY = {}


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (case-insensitive); an
    ``Optimizer`` instance is returned as it is."""
    if isinstance(name, Optimizer):
        return name
    klass = _REGISTRY.get(name.lower())
    if klass is None:
        raise MXNetError("optimizer %r is not registered; known: %s"
                         % (name, sorted(_REGISTRY)))
    return klass(**kwargs)


class Optimizer:
    """Base optimizer (reference: optimizer.py:46).

    ``param_dict`` maps an index to its parameter; the parameter's
    ``lr_mult`` and ``wd_mult`` scale ``lr`` and ``wd`` (``Trainer`` sets
    it, so weight decay applies to every parameter whose ``wd_mult`` is
    1, biases, betas and gammas included)."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.num_update = 0
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict if param_dict else {}

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _get_lr(self, index):
        if index in self.param_dict:
            return self.lr * self.param_dict[index].lr_mult
        return self.lr

    def _get_wd(self, index):
        if index in self.param_dict:
            return self.wd * self.param_dict[index].wd_mult
        return self.wd

    def _clip(self):
        """The ops' ``clip_gradient``: -1 (no clipping) when unset or 0."""
        return self.clip_gradient if self.clip_gradient else -1.0


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` is not 0 (reference:
    optimizer.py SGD)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad, clip_gradient=self._clip())
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py Adam).  The bias correction is folded
    into the learning rate on the host, in double precision, from the
    index's own update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def _bc_lr(self, index):
        t = max(1, self._index_update_count.get(index, 0))
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        return self._get_lr(index) * math.sqrt(coef2) / coef1

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        _ops.adam_update(weight, grad, mean, var, lr=self._bc_lr(index),
                         beta1=self.beta1, beta2=self.beta2,
                         epsilon=self.epsilon, wd=self._get_wd(index),
                         rescale_grad=self.rescale_grad,
                         clip_gradient=self._clip())


class Updater:
    """Applies an optimizer per index, creating each index's state at
    its first update (reference: optimizer.py:1608 get_updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
