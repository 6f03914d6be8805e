"""Optimizers of the PyTorch port.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (reference:
python/mxnet/optimizer/optimizer.py): the registry (``register``,
``create``), the ``Optimizer`` base with ``lr``, ``wd``,
``rescale_grad``, ``clip_gradient``, per-parameter multipliers from
``param_dict`` and per-index update counts, ``SGD`` (with momentum),
``Adam``, and the ``Updater`` that keeps each index's state (and saves
and restores it, ``get_states``/``set_states``).  Updates run
the in-place ops of :mod:`~mxnet_tpu_torch.ops.optimizer_ops`; there is
no ``torch.optim`` underneath.

A captured training step (``GluonTrainStep(optimizer=...)``) runs an
optimizer's ``update`` inside a CUDA graph, so the scalars that change
from step to step (the scheduled learning rate, Adam's bias-corrected
one) cannot be Python floats there: the graph would keep the first
step's.  :class:`scalar_feed` is the port's form of the JAX package's
(``mxnet_tpu/optimizer/optimizer.py:41``): while it is active the
optimizer reads each ``(index, name)`` scalar from the table it holds
(0-d device tensors, views of one buffer that the step refills before
each replay) and leaves its update counts to the step, which advances
them and computes the values on the host with :meth:`Optimizer.step_scalars`.
``compiled_step_safe`` says which optimizers read their per-step scalars
only so.
"""

from __future__ import annotations

import math
import pickle
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "register", "create",
           "get_updater", "scalar_feed", "feed_active"]

_REGISTRY = {}
_FEED = threading.local()


class scalar_feed:
    """A scope in which the optimizers read each per-step scalar
    ``(index, name)`` (``"lr"``, ``"wd"``) from ``table`` and leave their
    update counts alone: a captured step's update."""

    def __init__(self, table):
        self.table = table

    def __enter__(self):
        stack = getattr(_FEED, "stack", None)
        if stack is None:
            stack = _FEED.stack = []
        stack.append(self.table)
        return self

    def __exit__(self, *exc):
        _FEED.stack.pop()


def _fed(index, name):
    """The fed value of ``(index, name)``, or None with no feed active."""
    stack = getattr(_FEED, "stack", None)
    return stack[-1].get((index, name)) if stack else None


def feed_active():
    """True inside a :class:`scalar_feed` scope."""
    return bool(getattr(_FEED, "stack", None))


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
    """Base optimizer (reference: optimizer.py:46;
    ``mxnet_tpu/optimizer/optimizer.py:96-222``).

    The rate of an update is ``learning_rate``, or ``lr_scheduler``'s
    rate at the update count (which starts from ``begin_num_update``),
    times the parameter's ``lr_mult``; its weight decay is ``wd`` times
    its ``wd_mult``.  The multipliers come from ``param_dict`` (index ->
    parameter with ``lr_mult``/``wd_mult``, as ``Trainer`` sets it), else
    from :meth:`set_lr_mult`/:meth:`set_wd_mult` by index or by name
    (``param_idx2name``).  As in MXNet, the constructor applies the
    symbol's ``__lr_mult__``/``__wd_mult__`` attributes (``sym``) and the
    no-decay rule: a parameter whose name ends neither in ``_weight`` nor
    in ``_gamma`` takes no weight decay.

    ``compiled_step_safe``: whether ``update`` reads its per-step scalars
    only through :meth:`step_scalars`'s names (so a captured step may run
    it under a :class:`scalar_feed`); False here, True for ``SGD`` and
    ``Adam``."""

    compiled_step_safe = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    create_optimizer = staticmethod(create)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    @property
    def learning_rate(self):
        """The current rate: the scheduler's at the update count, if any."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined")
        self.lr = lr

    def _sym_mults(self, key):
        if not self.sym_info:
            return {}
        attr, arg_names = self.sym_info
        return {n: float(attr[n][key]) for n in arg_names
                if key in attr.get(n, {})}

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers by index or name, over the symbol's
        ``__lr_mult__`` attributes."""
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight-decay multipliers by index or name: 0 for every name of
        ``param_idx2name`` that ends neither in ``_weight`` nor in
        ``_gamma``, then the symbol's ``__wd_mult__`` attributes, then
        ``args_wd_mult``."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if feed_active():
            # a captured step advances the counts itself, once a step
            return
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _mult(self, index, table, attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in table:
            return table[index]
        return table.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index):
        fed = _fed(index, "lr")
        if fed is not None:
            return fed
        return self.learning_rate * self._mult(index, self.lr_mult,
                                               "lr_mult")

    def _get_wd(self, index):
        fed = _fed(index, "wd")
        if fed is not None:
            return fed
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def step_scalars(self, index):
        """The per-step scalars ``update`` reads for ``index``, computed on
        the host from the current update counts (a captured step calls it
        after advancing them): ``{"lr": ..., "wd": ...}``
        (``mxnet_tpu/optimizer/optimizer.py:240``)."""
        return {"lr": self._get_lr(index), "wd": self._get_wd(index)}

    def _clip(self):
        """The ops' ``clip_gradient``: -1 (no clipping) when unset or 0."""
        return self.clip_gradient if self.clip_gradient else -1.0


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` is not 0 (reference:
    optimizer.py SGD)."""

    compiled_step_safe = True

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

    compiled_step_safe = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def _bc_lr(self, index):
        fed = _fed(index, "lr")
        if fed is not None:
            return fed
        t = max(1, self._index_update_count.get(index, 0))
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        return self._get_lr(index) * math.sqrt(coef2) / coef1

    def step_scalars(self, index):
        """The bias-corrected rate and the weight decay
        (``mxnet_tpu/optimizer/optimizer.py:482``)."""
        return {"lr": self._bc_lr(index), "wd": self._get_wd(index)}

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
        elif _is_host(self.states[index]):  # restored by set_states
            self.states[index] = _to_device(self.states[index], weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states (and the optimizer, with ``dump_optimizer``) as
        bytes, the tensors as numpy arrays."""
        states = {k: _to_host(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states):
        """Restore what :meth:`get_states` gave; each state moves to its
        weight's device at the index's next update."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        self.states = states


def _to_host(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_host(s) for s in state)
    return state


def _is_host(state):
    if isinstance(state, (tuple, list)):
        return any(_is_host(s) for s in state)
    return isinstance(state, np.ndarray)


def _to_device(state, weight):
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state).to(weight.device)
    if isinstance(state, (tuple, list)):
        return type(state)(_to_device(s, weight) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)
