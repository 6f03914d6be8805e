"""Optimizers of the PyTorch port.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (reference:
python/mxnet/optimizer/optimizer.py): the registry (``register``,
``create``), the ``Optimizer`` base with ``lr``, ``wd``,
``rescale_grad``, ``clip_gradient``, per-parameter multipliers from
``param_dict``, per-index update counts and ``multi_precision``, the
optimizers ``SGD`` (alias ``ccSGD``), ``NAG``, ``Signum``, ``Adam``,
``Adamax``, ``Nadam``, ``FTML``, ``Ftrl``, ``RMSProp`` (plain and
centered), ``AdaGrad``, ``AdaDelta``, ``LBSGD``, ``DCASGD``, ``SGLD`` and
``Test``, and the ``Updater`` that keeps each index's state (and saves
and restores it, ``get_states``/``set_states``).  Updates run the
in-place ops of :mod:`~mxnet_tpu_torch.ops.optimizer_ops`, or, where the
JAX class computes in NDArray arithmetic (``Test``, ``LBSGD``,
``DCASGD``, ``SGLD``), the same arithmetic on tensors; there is no
``torch.optim`` underneath.

``multi_precision=True``: a float16 weight is updated through a float32
master copy kept in its state (``create_state_multi_precision``,
``update_multi_precision``), and becomes the master's rounding after
each update.  As in the JAX package the masters are made for float16
weights only: a bf16 weight is updated in bf16.

A captured training step (``GluonTrainStep(optimizer=...)``,
``Trainer.compile``) runs an optimizer's ``update`` inside a CUDA graph,
so the scalars that change from step to step (the scheduled learning
rate, Adam's bias-corrected one, FTML's and Adamax's step count ``t``)
cannot be Python floats there: the graph would keep the first step's.
:class:`scalar_feed` is the port's form of the JAX package's
(``mxnet_tpu/optimizer/optimizer.py:41``): while it is active the
optimizer reads each ``(index, name)`` scalar from the table it holds
(0-d device tensors, views of one buffer that the step refills before
each replay) and leaves its update counts to the step, which advances
them and computes the values on the host with :meth:`Optimizer.step_scalars`.
``compiled_step_safe`` says which optimizers read their per-step scalars
only so: SGD, NAG, Signum, Adam, Adamax, FTML, Ftrl, RMSProp, AdaGrad and
AdaDelta.
"""

from __future__ import annotations

import math
import pickle
import threading

import numpy as np
import torch

from .. import random as _random
from ..base import MXNetError
from ..ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "Signum", "Adam", "Adamax",
           "Nadam", "FTML", "Ftrl", "RMSProp", "AdaGrad", "AdaDelta",
           "LBSGD", "DCASGD", "SGLD", "Test", "Updater", "register",
           "create", "get_updater", "scalar_feed", "feed_active"]

_REGISTRY = {}
_FEED = threading.local()


class scalar_feed:
    """A scope in which the optimizers read each per-step scalar
    ``(index, name)`` (``"lr"``, ``"wd"``, ``"t"``) from ``table`` and
    leave their update counts alone: a captured step's update."""

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
    ``mxnet_tpu/optimizer/optimizer.py:96-258``).

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

    A pickled optimizer leaves out its ``lr_scheduler`` (as the JAX
    package's does) and its ``param_dict`` (as MXNet's does: it holds the
    parameters themselves); ``Trainer.load_states`` gives the loaded
    optimizer both back.

    ``compiled_step_safe``: whether ``update`` reads its per-step scalars
    only through :meth:`step_scalars`'s names (so a captured step may run
    it under a :class:`scalar_feed`)."""

    compiled_step_safe = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
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
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    create_optimizer = staticmethod(create)

    def create_state(self, index, weight):
        return None

    def _mastered(self, weight):
        return self.multi_precision and weight.dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        """The state of ``weight``; with ``multi_precision`` and a float16
        weight, ``(float32 master, the master's state)``."""
        if self._mastered(weight):
            master = weight.detach().to(torch.float32, copy=True)
            return master, self.create_state(index, master)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`; with ``multi_precision`` and a float16 weight,
        on the float32 master with the gradient widened, then the weight
        (in its own storage) becomes the master's rounding."""
        if self._mastered(weight):
            master, base_state = state
            self.update(index, master, grad.float(), base_state)
            with torch.no_grad():
                weight.copy_(master)
        else:
            self.update(index, weight, grad, state)

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

    def _t(self, index):
        """The step count of ``index`` the update derives its bias
        corrections from: the fed ``t`` under a :class:`scalar_feed`, else
        the count the update has just advanced."""
        fed = _fed(index, "t")
        if fed is not None:
            return fed
        return self._index_update_count[index]

    def _t_host(self, index):
        """The host's step count of ``index`` for :meth:`step_scalars` (1
        before the first update)."""
        return max(1, self._index_update_count.get(index, 0))

    def step_scalars(self, index):
        """The per-step scalars ``update`` reads for ``index``, computed on
        the host from the current update counts (a captured step calls it
        after advancing them): ``{"lr": ..., "wd": ...}``
        (``mxnet_tpu/optimizer/optimizer.py:240``)."""
        return {"lr": self._get_lr(index), "wd": self._get_wd(index)}

    def _clip(self):
        """The ops' ``clip_gradient``: -1 (no clipping) when unset or 0."""
        return self.clip_gradient if self.clip_gradient else -1.0

    def _fused(self, op, index, weight, grad, states, **extra):
        """Run the update op ``op`` with this index's rate, decay,
        ``rescale_grad`` and ``clip_gradient``."""
        op(weight, grad, *states, lr=self._get_lr(index),
           wd=self._get_wd(index), rescale_grad=self.rescale_grad,
           clip_gradient=self._clip(), **extra)

    def _rescaled(self, grad):
        """``rescale_grad * grad``, clipped when ``clip_gradient`` is set
        (the NDArray arithmetic of the JAX classes without an op)."""
        g = grad * self.rescale_grad
        if self.clip_gradient:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("lr_scheduler", None)
        d.pop("param_dict", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.lr_scheduler = None
        self.param_dict = {}


def _zeros(weight, n):
    """``n`` zero tensors like ``weight``."""
    return tuple(torch.zeros_like(weight) for _ in range(n))


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` is not 0 (reference:
    optimizer.py SGD).  ``lazy_update`` is taken for the row-sparse
    updates, which the port has not yet (ROADMAP Queue 1 item 6)."""

    compiled_step_safe = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        if state is None:
            self._fused(_ops.sgd_update, index, weight, grad, ())
        else:
            self._fused(_ops.sgd_mom_update, index, weight, grad, (state,),
                        momentum=self.momentum)


# the reference's deprecated alias
ccSGD = register(type("ccSGD", (SGD,), {"__doc__": "SGD under its old "
                                                   "name."}))


@register
class Test(Optimizer):
    """``w += rescale_grad * g``; the state is the new weight (reference:
    optimizer.py Test)."""

    def create_state(self, index, weight):
        return torch.zeros(weight.shape, dtype=torch.float32,
                           device=weight.device)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.add_(grad * self.rescale_grad)
        state.copy_(weight)


@register
class LBSGD(SGD):
    """Large-batch SGD: the rate scaled by the LARS trust ratio
    ``min(|w| / (|g| + wd |w| + 1e-9), 10)`` (reference: optimizer.py
    LBSGD).  The norms are read on the host, so it is not compiled-step
    safe."""

    compiled_step_safe = False

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.adaptive = True

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        wnorm = float(weight.norm())
        gnorm = float(grad.norm()) * self.rescale_grad
        if wnorm > 0 and gnorm > 0:
            lr = lr * min(wnorm / (gnorm + wd * wnorm + 1e-9), 10.0)
        g = self._rescaled(grad) + wd * weight
        if state is not None:
            state.copy_(self.momentum * state - lr * g)
            weight.add_(state)
        else:
            weight.sub_(lr * g)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py
    DCASGD): the state is the momentum (None at 0) and the previous
    weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.detach().clone()
        if self.momentum == 0.0:
            return None, prev
        return torch.zeros_like(weight), prev

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._rescaled(grad)
        mom, prev = state
        comp = g + self.lamda * g * g * (weight - prev)
        if mom is not None:
            mom.copy_(self.momentum * mom - lr * (comp + wd * weight))
            step = mom
        else:
            step = -lr * (comp + wd * weight)
        prev.copy_(weight)
        weight.add_(step)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: optimizer.py NAG)."""

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
        if state is None:
            self._fused(_ops.sgd_update, index, weight, grad, ())
        else:
            self._fused(_ops.nag_mom_update, index, weight, grad, (state,),
                        momentum=self.momentum)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py
    SGLD): ``w -= lr / 2 * (g + wd w)`` plus normal noise of variance
    ``lr``, drawn from the port's generator of the weight's device."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._rescaled(grad)
        noise = torch.randn(weight.shape, dtype=weight.dtype,
                            device=weight.device,
                            generator=_random.generator(weight.device))
        weight.copy_(weight - lr / 2 * (g + wd * weight)
                     + noise * math.sqrt(lr))


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py Adam).  The bias correction is folded
    into the learning rate on the host, in double precision, from the
    index's own update count.  ``lazy_update`` as :class:`SGD`'s."""

    compiled_step_safe = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _bc_lr(self, index):
        fed = _fed(index, "lr")
        if fed is not None:
            return fed
        t = self._t_host(index)
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


@register
class Signum(Optimizer):
    """signSGD with momentum (reference: optimizer.py Signum)."""

    compiled_step_safe = True

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        if state is None:
            self._fused(_ops.signsgd_update, index, weight, grad, ())
        else:
            self._fused(_ops.signum_update, index, weight, grad, (state,),
                        momentum=self.momentum, wd_lh=self.wd_lh)


class _StepCounted(Optimizer):
    """An optimizer whose update reads the step count ``t`` too."""

    def step_scalars(self, index):
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "t": float(self._t_host(index))}


@register
class FTML(_StepCounted):
    """Follow The Moving Leader (reference: optimizer.py FTML)."""

    compiled_step_safe = True

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 3)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _ops.ftml_update(weight, grad, *state, lr=self._get_lr(index),
                         wd=self._get_wd(index),
                         rescale_grad=self.rescale_grad,
                         clip_grad=self._clip(), beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon,
                         t=self._t(index))


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: optimizer.py Ftrl)."""

    compiled_step_safe = True

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._fused(_ops.ftrl_update, index, weight, grad, state,
                    lamda1=self.lamda1, beta=self.beta)


@register
class Adamax(_StepCounted):
    """Adamax (reference: optimizer.py Adamax), one update op."""

    compiled_step_safe = True

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._fused(_ops.adamax_update, index, weight, grad, state,
                    beta1=self.beta1, beta2=self.beta2, t=self._t(index))


@register
class Nadam(Optimizer):
    """Nadam (reference: optimizer.py Nadam), one update op.  The
    momentum schedule's product is kept on the host across steps, so it
    is not compiled-step safe."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        self._fused(_ops.nadam_update, index, weight, grad, state,
                    beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                    t=t, m_schedule=self.m_schedule, momentum_t=momentum_t,
                    momentum_t_1=momentum_t_1)


@register
class AdaGrad(Optimizer):
    """AdaGrad over a dense history (reference: optimizer.py AdaGrad);
    the row-sparse update waits for sparse NDArrays."""

    compiled_step_safe = True

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._fused(_ops.adagrad_update, index, weight, grad, (state,),
                    epsilon=self.float_stable_eps)


@register
class RMSProp(Optimizer):
    """RMSProp (reference: optimizer.py RMSProp): Tieleman and Hinton's,
    or Graves's with ``centered=True``; ``clip_weights`` clips the plain
    variant's weights after the update."""

    compiled_step_safe = True

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return _zeros(weight, 3 if self.centered else 1)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        if self.centered:
            self._fused(_ops.rmspropalex_update, index, weight, grad, state,
                        gamma1=self.gamma1, gamma2=self.gamma2,
                        epsilon=self.epsilon)
        else:
            self._fused(_ops.rmsprop_update, index, weight, grad, state,
                        gamma1=self.gamma1, epsilon=self.epsilon,
                        clip_weights=self.clip_weights
                        if self.clip_weights else -1.0)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py AdaDelta): no learning rate in
    the step."""

    compiled_step_safe = True

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._fused(_ops.adadelta_update, index, weight, grad, state,
                    rho=self.rho, epsilon=self.epsilon)


class Updater:
    """Applies an optimizer per index, creating each index's state at
    its first update (reference: optimizer.py:1608 get_updater), through
    ``create_state_multi_precision`` and ``update_multi_precision``.

    ``states_synced[i]``: whether state ``i`` lies on its weight's device
    (a state restored by :meth:`set_states` moves there at its next
    update).  ``generation`` counts the :meth:`set_states` calls: a
    captured step that holds the old state tensors drops its graphs when
    it moves.  ``aggregate_updates`` is the JAX package's flag (no
    aggregated path here either)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = False
        self.generation = 0

    def state(self, index, weight):
        """Index ``index``'s state on ``weight``'s device, made (or moved
        there) first if need be."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = _to_device(self.states[index], weight)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.state(index, weight))

    def get_states(self, dump_optimizer=False):
        """The states (and the optimizer, with ``dump_optimizer``) as
        bytes, the tensors on the host (numpy arrays; bf16 as CPU
        tensors, which numpy lacks)."""
        states = {k: _to_host(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states):
        """Restore what :meth:`get_states` gave (adopting its optimizer,
        if it holds one); each state moves to its weight's device at the
        index's next update."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        self.states = states
        self.states_synced = dict.fromkeys(states, False)
        self.generation += 1


def _to_host(state):
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu()
        return state if state.dtype == torch.bfloat16 else state.numpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_host(s) for s in state)
    return state


def _to_device(state, weight):
    if isinstance(state, np.ndarray):
        state = torch.from_numpy(state)
    if isinstance(state, torch.Tensor):
        return state.to(weight.device)
    if isinstance(state, (tuple, list)):
        return type(state)(_to_device(s, weight) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)
