"""The whole training step of a Gluon block as one program:
``Trainer.compile``.

Counterpart of ``mxnet_tpu/compiled_step.py`` (``:113-509``) on one
device.  ``cs = trainer.compile(net, loss_fn)`` returns a
:class:`CompiledStep`; ``cs.step(x, y)`` replaces ``record()``,
``backward()`` and ``trainer.step(batch)`` and returns the loss block's
per-sample output.  One step is:

1. the forward and the loss, in train mode;
2. the gradients of the loss's sum (a ones cotangent, as eager
   ``backward()`` seeds);
3. ``rescale_grad = trainer._scale / batch``, then the Trainer's own
   ``Updater`` on every trainable parameter, in place: the optimizer's
   ``update_multi_precision`` (float32 masters for float16 weights with
   ``multi_precision``), its state made before the first step;
4. the BatchNorm running statistics, updated in place by the layers
   during the forward.

On the card the step is one captured CUDA graph for each key of x's and
y's shapes and dtypes and ``rescale_grad`` (``compiled_step.py:437-441``),
through the capture of ``GluonTrainStep`` (``parallel/gluon_step.py``
``_StepGraph``: an eager warm-up whose effects are undone, then
``torch.cuda.graph``): the first step at a key captures, every step
replays.  The per-step scalars (the scheduled rate, Adam's bias-corrected
one, FTML's and Adamax's ``t``) are computed on the host after it
advances the update counts, once a step, and copied into one small device
buffer that the update reads (``ScalarFeed``), so a schedule never
recaptures.  A ``Block.cast``, ``Trainer.load_states`` (new state
tensors, a new optimizer) or any ``Updater.set_states`` drops the
graphs.  On the CPU the step runs eagerly under the same keys.

The step updates the parameters and states in place, where the JAX
package donates their buffers and rebinds new ones; either way a
reference taken before a step sees it afterwards (:func:`donation_active`).
Only compiled-step-safe optimizers are taken (SGD, NAG, Signum, Adam,
Adamax, FTML, Ftrl, RMSProp, AdaGrad, AdaDelta); ``zero=True`` (ZeRO's
sharded update, or ``MXNET_TPU_ZERO=1``) raises until multi-GPU training
is ported (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import os

import torch

from . import _capture
from . import autograd as _autograd
from . import runtime_stats as _rts
from .base import MXNetError
from .gluon.block import cast_generation, is_deferred
from .gluon.trainer import _StepTelemetry
from .optimizer import scalar_feed
from .parallel.gluon_step import (ScalarFeed, _leaves, _StepGraph, put,
                                  zero_env_enabled)

__all__ = ["CompiledStep", "compile_step", "env_enabled", "donation_active"]

# True once any CompiledStep has stepped in this process
_state = {"donating": False}


def donation_active():
    """True once a :class:`CompiledStep` has stepped in this process: a
    parameter or state captured by reference is updated by later steps,
    so a snapshot must copy it."""
    return _state["donating"]


def env_enabled():
    """True when ``MXNET_TPU_COMPILED_STEP=1`` asks a launcher to train
    through the compiled step."""
    return os.environ.get("MXNET_TPU_COMPILED_STEP") == "1"


def compile_step(block, loss, trainer, zero=None, mesh=None):
    """A :class:`CompiledStep` of ``block``, ``loss`` and ``trainer``'s
    optimizer.  ``zero`` (default: ``MXNET_TPU_ZERO=1``) raises
    :class:`MXNetError`: ZeRO's sharded update needs more than one
    device.  ``mesh`` is the ZeRO path's and unused here, as in the JAX
    package."""
    del mesh
    if zero_env_enabled() if zero is None else zero:
        raise MXNetError(
            "compiled_step: zero=True (ZeRO weight-update sharding over the "
            "'dp' axis of a device mesh) needs more than one device; the "
            "port trains on one device, and multi-GPU training is not yet "
            "ported (ROADMAP Queue 1 item 9)")
    return CompiledStep(block, loss, trainer)


def _guard_trainer(trainer):
    """The Trainer must update on the worker, on one device, with a
    compiled-step-safe optimizer."""
    opt = trainer._optimizer
    if not getattr(opt, "compiled_step_safe", False):
        raise MXNetError(
            "compiled_step: optimizer %s is not compiled-step safe (host "
            "syncs, cross-step host recurrences, or host-scalar math in "
            "update()); supported: SGD, NAG, Signum, Adam, Adamax, FTML, "
            "Ftrl, RMSProp, AdaGrad, AdaDelta.  Use the eager Trainer path "
            "instead." % type(opt).__name__)
    if trainer._update_on_kvstore or len(trainer._contexts) > 1:
        raise MXNetError("compiled_step: the update must run on the worker "
                         "and on one device")


class _Eager:
    """A CPU entry: the step run eagerly under its key."""

    def __init__(self, step):
        self.step = step
        self.replays = 0

    def run(self, x, y):
        self.replays += 1
        return self.step._eager(x, y)


class CompiledStep:
    """``block``'s forward, ``loss``, the backward and ``trainer``'s
    update as one step (module docstring).  ``graphs``: key ->
    ``_StepGraph`` on the card (its ``replays`` count the steps it ran),
    an eager stand-in on the CPU."""

    def __init__(self, block, loss, trainer):
        self.block = block
        self.loss_block = loss
        self.trainer = trainer
        _guard_trainer(trainer)
        params = block.collect_params().values()
        devices = {p.device for p in params}
        if len(devices) != 1:
            raise MXNetError("compiled_step: the block's parameters lie on "
                             "%s, not on one device"
                             % sorted(map(str, devices)))
        (self.device,) = devices
        self._capture = self.device.type == "cuda"
        self.graphs = {}
        self._valid = None
        self.opt_state = []
        self.trainable = None
        if not any(is_deferred(p) for p in params):
            self._bind()

    def _bind(self):
        """The trainable and auxiliary parameters and each trainable's
        index in the Trainer; raises where the block and the Trainer
        disagree."""
        params = self.block.collect_params()
        self.trainable = [p for p in params.values() if p.grad_req != "null"]
        self.aux = [p for p in params.values() if p.grad_req == "null"]
        if not self.trainable:
            raise MXNetError("compiled_step: block has no trainable "
                             "parameters")
        self._index = {}
        for name, p in params.items():
            if p.grad_req == "null":
                continue
            i = self.trainer._param2idx.get(p)
            if i is None:
                raise MXNetError(
                    "compiled_step: parameter %r is not managed by this "
                    "Trainer -- pass the same collect_params() the Trainer "
                    "was built with" % name)
            self._index[p] = i
        for i, p in enumerate(self.trainer._params):
            if p.grad_req != "null" and p not in self._index:
                raise MXNetError(
                    "compiled_step: Trainer parameter %d (shape %s) is not "
                    "part of this block -- it would silently stop updating; "
                    "compile the block that owns every trainable parameter"
                    % (i, tuple(p.shape)))

    def _graphs(self):
        """The entries, dropped (with the scalar buffer rebuilt) after a
        ``Block.cast``, an ``Updater.set_states`` or a new optimizer on the
        Trainer: they read the old parameters, states or scalars."""
        trainer = self.trainer
        now = (cast_generation(), trainer._updaters[0].generation,
               trainer._optimizer)
        if self._valid != now:
            _guard_trainer(trainer)
            self.graphs, self._valid = {}, now
            self._feed = ScalarFeed(
                trainer._optimizer, [self._index[p] for p in self.trainable],
                self.device)
        return self.graphs

    def _ensure_states(self):
        """Every trainable's optimizer state on the device, made before
        the warm-up and the capture (float32 masters included), as the
        Updater makes it at a first eager update."""
        upd = self.trainer._updaters[0]
        with torch.no_grad():
            self.opt_state = [t for p in self.trainable
                              for t in _leaves(upd.state(self._index[p], p))]

    def _eager(self, x, y):
        """One step, eagerly: ``(per-sample loss,)``."""
        with _capture.staging(), _autograd.record():
            loss = self.loss_block(self.block(x), y)
        if not isinstance(loss, torch.Tensor):
            raise MXNetError("compiled_step: the loss must return one "
                             "tensor, got %r" % type(loss).__name__)
        grads = torch.autograd.grad(loss, self.trainable,
                                    torch.ones_like(loss), allow_unused=True)
        upd = self.trainer._updaters[0]
        with torch.no_grad(), scalar_feed(self._feed.table):
            for p, g in zip(self.trainable, grads):
                upd(self._index[p], torch.zeros_like(p) if g is None else g,
                    p)
        return (loss.detach(),)

    def step(self, x, y):
        """One training step on ``(x, y)`` (host arrays or tensors);
        returns the per-sample loss, a fresh tensor on the device, not
        synchronised.  Counts ``trainer_steps`` and
        ``compiled_step_steps`` and times the step into the
        ``trainer:step`` histogram, as ``Trainer.step``."""
        _rts.inc("trainer_steps")
        _rts.inc("compiled_step_steps")
        with _StepTelemetry():
            return self._step(x, y)

    def _step(self, x, y):
        x, y = put(x, self.device), put(y, self.device)
        if self.trainable is None:  # deferred shapes: one forward first
            with torch.no_grad():
                self.block(x)
            self._bind()
        opt = self.trainer._optimizer
        opt.rescale_grad = self.trainer._scale / x.shape[0]
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               float(opt.rescale_grad))
        graphs = self._graphs()
        # this step's counts and scalars, before a first step's warm-up
        # and capture read them
        self._feed.refill(opt)
        entry = graphs.get(key)
        if entry is None:
            self._ensure_states()
            entry = graphs[key] = _StepGraph(self, x, y, 1) \
                if self._capture else _Eager(self)
        _state["donating"] = True
        (loss,) = entry.run(x, y)
        return loss
