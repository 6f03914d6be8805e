"""Gluon Trainer of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py) on one device: ``step(batch_size)`` sets
the optimizer's ``rescale_grad`` to ``1 / batch_size`` and updates every
parameter whose ``grad_req`` is not ``'null'`` from its ``.grad``;
``allreduce_grads`` has nothing to reduce.  ``kvstore`` takes the values
that mean no store on one device (``"device"``, ``"local"``, None,
False); a distributed store, a store object and ``update_on_kvstore=True``
raise until multi-GPU training is ported (ROADMAP Queue 1 item 9).
``save_states``/``load_states`` write and read the JAX package's file
format; :meth:`Trainer.compile` makes the whole step one captured program
(:mod:`~mxnet_tpu_torch.compiled_step`).
"""

from __future__ import annotations

import pickle
import time

import torch

from .. import checkpoint as _ckpt
from .. import histogram as _histogram
from .. import optimizer as _optimizer
from .. import runtime_stats as _rts
from ..base import MXNetError
from .block import Parameter

__all__ = ["Trainer"]


class _StepTelemetry:
    """The per-step instrumentation shared by ``Trainer.step`` and
    ``CompiledStep.step`` (``mxnet_tpu/gluon/trainer.py:34-108``): the
    ``trainer:step`` histogram of the step's wall time (seconds), when
    the histograms are on, for a step that did not raise.

    The JAX class's other hooks wait for their layers: the profiler span,
    health and its crash dump, device memory, the stepstats window, the
    metrics timeline and the autopilot (ROADMAP Queue 1 item 10), and the
    auto-checkpoint (item 5)."""

    def __enter__(self):
        self._t0 = time.perf_counter() if _histogram._state["on"] else None
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self._t0 is not None:
            _histogram.observe("trainer:step",
                               time.perf_counter() - self._t0)
        return False


def _one_device_store(kvstore, update_on_kvstore):
    """Refuse what needs more than one device: a distributed store, a
    store object, updates on the store."""
    if not (kvstore is None or kvstore is False or (
            isinstance(kvstore, str) and "dist" not in kvstore)):
        raise MXNetError("Trainer: kvstore %r is not ported; one device "
                         "takes 'device', 'local', None or False, and "
                         "multi-GPU training is not yet ported (ROADMAP "
                         "Queue 1 item 9)" % (kvstore,))
    if update_on_kvstore:
        raise MXNetError(
            "Trainer: update_on_kvstore=True runs the optimizer on the "
            "store; the port trains on one device with no store, and "
            "multi-GPU training is not yet ported (ROADMAP Queue 1 item 9)")


class Trainer:
    """Applies an optimizer to a set of parameters.

    ``params``: a dict (``Block.collect_params()``) or a list of
    parameters, all on one device; ``optimizer``: a registered name or an
    ``Optimizer``; ``optimizer_params``: its keyword arguments (for
    example ``{"learning_rate": 1e-3, "multi_precision": True}``);
    ``kvstore``, ``compression_params``, ``update_on_kvstore``: see the
    module docstring.  ``_param2idx`` maps each parameter (the object) to
    its index in the optimizer."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a list/dict of Parameters")
        self._params = []
        self._param2idx = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise ValueError("invalid parameter %r" % (p,))
            self._param2idx[p] = i
            self._params.append(p)
        _one_device_store(kvstore, update_on_kvstore)
        self._contexts = sorted({p.device for p in self._params}, key=str)
        if len(self._contexts) > 1:
            raise ValueError("All Parameters must be on one device, not %s"
                             % [str(d) for d in self._contexts])
        self._compression_params = compression_params
        self._kvstore_type = kvstore
        self._kvstore = None
        self._update_on_kvstore = False
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
        self._updaters = [_optimizer.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def compile(self, block, loss, zero=None, mesh=None):
        """``block``'s forward, ``loss``, the backward and this Trainer's
        update as one training step: ``cs = trainer.compile(net,
        loss_fn)``, then ``cs.step(x, y)`` in place of ``record()``,
        ``backward()`` and ``step(batch)``
        (:class:`~mxnet_tpu_torch.compiled_step.CompiledStep`)."""
        from .. import compiled_step as _compiled

        return _compiled.compile_step(block, loss, self, zero=zero,
                                      mesh=mesh)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients (nothing to do on one device) and update
        with ``rescale_grad = 1 / batch_size``; counts ``trainer_steps``
        and times the step into the ``trainer:step`` histogram."""
        _rts.inc("trainer_steps")
        with _StepTelemetry():
            self._optimizer.rescale_grad = self._scale / batch_size
            self._update(ignore_stale_grad)

    def _worker_update(self, what):
        if self._update_on_kvstore:
            raise ValueError(
                "%s() is not supported when updates run on the kvstore "
                "(update_on_kvstore=True); use step() or pass "
                "update_on_kvstore=False" % what)

    def allreduce_grads(self):
        """One device and no kvstore: the gradients are already whole."""
        self._worker_update("allreduce_grads")

    def update(self, batch_size, ignore_stale_grad=False):
        """Update without reducing, after :meth:`allreduce_grads`."""
        self._worker_update("update")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        del ignore_stale_grad  # as the JAX package: every grad is used
        updater = self._updaters[0]
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            # a parameter no backward has reached yet has a zero gradient
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            updater(i, grad, p)

    def save_states(self, fname):
        """Write the optimizer and its states (``mxnet_tpu/gluon/
        trainer.py:376-396``): the magic, a version byte, a newline, then
        the pickled ``get_states(dump_optimizer=True)``, through a
        temporary file, fsync and a rename."""
        payload = self._updaters[0].get_states(dump_optimizer=True)
        with _ckpt.atomic_write(fname) as tmp:
            with open(tmp, "wb") as f:
                f.write(_ckpt.TRAINER_STATES_MAGIC)
                f.write(bytes([_ckpt.TRAINER_STATES_VERSION]))
                f.write(b"\n")
                f.write(payload)

    def load_states(self, fname):
        """Read what :meth:`save_states` wrote, or a legacy headerless
        file (a pickle of those bytes, or the bytes themselves); a version
        above this build's raises ``ValueError``.  As MXNet's Trainer, this
        one adopts the loaded optimizer (the JAX package's keeps its old
        one, ROADMAP "Faults of the reference"), and gives it this
        Trainer's parameters and learning-rate schedule, which a pickle
        leaves out."""
        magic = _ckpt.TRAINER_STATES_MAGIC
        with open(fname, "rb") as f:
            data = f.read()
        if data.startswith(magic):
            version = data[len(magic)]
            if version > _ckpt.TRAINER_STATES_VERSION:
                raise ValueError(
                    "trainer states file %s has version %d; this build "
                    "understands <= %d" % (fname, version,
                                           _ckpt.TRAINER_STATES_VERSION))
            payload = data[len(magic) + 2:]
        else:
            legacy = pickle.loads(data)
            payload = legacy if isinstance(legacy, bytes) else data
        scheduler = self._optimizer.lr_scheduler
        for updater in self._updaters:
            updater.set_states(payload)
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        if self._optimizer.lr_scheduler is None:
            self._optimizer.lr_scheduler = scheduler
