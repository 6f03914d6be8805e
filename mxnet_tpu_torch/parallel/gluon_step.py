"""Training step of the PyTorch port built from a Gluon block.

Counterpart of ``mxnet_tpu/parallel/gluon_step.py`` ``GluonTrainStep``
(its classic path, on one device), ``sgd_momentum_update`` and
``zero_env_enabled``.  The JAX
package traces forward, loss, backward, the update and the BatchNorm
running-stat update into one jitted program over a device mesh
(``:407-417``), and ``make_chained(n)`` runs n of them with one dispatch
(``:563-625``).  The port's step on one device:

1. with ``compute_dtype`` set, the float32 trainables and the input are
   cast to it (``.to``, differentiable); the running statistics
   (``grad_req='null'``) stay float32;
2. forward through :func:`torch.func.functional_call` on the cast
   copies, in train mode, then the loss's mean over the batch;
3. the gradients of the float32 masters, through the casts: a bf16
   gradient is rounded to bf16 and widened to float32, as the JAX
   package's ``g.astype(v.dtype)``;
4. ``g += wd * w; s = momentum * s + g; w -= lr * s`` on every trainable,
   in place; or, with ``optimizer=``, that optimizer's own ``update`` on
   each trainable and its state, in place;
5. the running statistics, updated in place by the BatchNorm layers
   during the forward.

With ``optimizer=`` (an optimizer whose ``compiled_step_safe`` is True:
SGD, NAG, Signum, Adam, Adamax, FTML, Ftrl, RMSProp, AdaGrad, AdaDelta)
the update reads its per-step scalars (the scheduled rate, Adam's
bias-corrected one, the weight decay, a step count) from one small
buffer on the step's device (:class:`ScalarFeed`), through
:class:`~..optimizer.scalar_feed`: before each step the host advances the
optimizer's update counts, computes the scalars
(:meth:`~..optimizer.Optimizer.step_scalars`) and copies them into the
buffer, so a schedule never recaptures and no Python float is kept in the
graph (the JAX package feeds them to its jitted step as arguments,
``:183-222``).

On the card the step is one captured CUDA graph per batch signature
(:mod:`.._capture`), the counterpart of the jitted ``_step``: the first
call at a signature warms up eagerly (its effects undone), captures the
step and replays it; every later call copies the batch into the graph's
static inputs and replays.  ``make_chained(n)`` captures n steps into one
graph, launched once.  A :meth:`~..gluon.Block.cast` of the block drops
every captured graph (they read the parameters' old storage).  On the CPU
the step runs eagerly.

The float32 masters stay the block's own Parameters, so
:meth:`GluonTrainStep.sync_to_params` has nothing to do.  The port runs
the step on one device: ``param_spec_fn``, ``data_spec`` and
``label_spec`` are taken (the first is called on every parameter, as the
JAX step lays its shardings out) and change nothing, and ``zero=True``
(ZeRO's sharded update, or ``MXNET_TPU_ZERO=1``) raises, as a mesh of
more than one device does: multi-GPU training is not yet ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import _capture
from .. import autograd as _autograd
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import cast_generation, is_deferred
from ..optimizer import scalar_feed

__all__ = ["GluonTrainStep", "sgd_momentum_update", "zero_env_enabled"]


def zero_env_enabled():
    """True when ``MXNET_TPU_ZERO=1`` asks for the ZeRO step."""
    return os.environ.get("MXNET_TPU_ZERO") == "1"


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


class ScalarFeed:
    """The per-step scalars of ``optimizer``'s update for ``indices``:
    ``buffer``, one float32 slot a (index, scalar name) on ``device``,
    and ``table``, its 0-d views by slot, which the update reads under
    :class:`~..optimizer.scalar_feed`."""

    def __init__(self, optimizer, indices, device):
        self.indices = list(indices)
        self.slots = [(i, name) for i in self.indices
                      for name in sorted(optimizer.step_scalars(i))]
        self.buffer = torch.zeros(len(self.slots), dtype=torch.float32,
                                  device=device)
        self.table = {slot: self.buffer[k]
                      for k, slot in enumerate(self.slots)}

    def refill(self, optimizer):
        """Advance ``optimizer``'s update counts by one step and copy this
        step's scalars into the buffer, ordered on the device before the
        step (the host copy is pinned, so it does not wait for the
        device)."""
        values = {}
        for i in self.indices:
            optimizer._update_count(i)
            values[i] = optimizer.step_scalars(i)
        host = torch.tensor([float(values[i][name]) for i, name in self.slots],
                            dtype=torch.float32)
        if self.buffer.device.type == "cuda":
            host = host.pin_memory()
        self.buffer.copy_(host, non_blocking=True)


class _StepGraph:
    """``n`` training steps at one batch signature, captured as one CUDA
    graph after an eager warm-up whose effects are undone.  ``step`` has
    ``_eager(x, y)`` (one step, returning a tuple of tensors), ``device``
    and the state the step updates in place, ``trainable``, ``opt_state``
    and ``aux`` (a ``GluonTrainStep``, a ``CompiledStep``).  ``x`` and
    ``y`` are the graph's static inputs; ``outs``, the last step's
    results, its static outputs."""

    def __init__(self, step, x, y, n):
        dev = step.device
        _capture.warm_up(lambda: step._eager(x, y),
                         step.trainable + step.opt_state + step.aux, dev)
        self.x, self.y = x.clone(), y.clone()

        def body():
            for _ in range(n):
                outs = step._eager(self.x, self.y)
            return outs

        self.graph, self.outs = _capture.capture(body, dev)
        self.replays = 0

    def load(self, x, y):
        """Copy a batch into the static inputs; returns them."""
        for s, v in ((self.x, x), (self.y, y)):
            if s.data_ptr() != v.data_ptr():
                s.copy_(v)
        return self.x, self.y

    def run(self, x, y):
        """Replay on ``(x, y)``: fresh copies of the results."""
        self.load(x, y)
        self.graph.replay()
        self.replays += 1
        return tuple(o.clone() for o in self.outs)


def _one_device_mesh(mesh):
    """Refuse a mesh of more than one device.  A mesh is duck-typed: any
    object whose ``devices`` holds its devices (a JAX ``Mesh``'s array,
    a list); None is the one device of the step."""
    if mesh is None:
        return None
    devices = getattr(mesh, "devices", None)
    if devices is None:
        raise MXNetError("GluonTrainStep: the third argument is the mesh: "
                         "None or an object with a 'devices' attribute, "
                         "not %r (the device is the keyword device=)"
                         % (mesh,))
    n = int(np.size(np.asarray(devices, dtype=object)))
    if n != 1:
        raise MXNetError(
            "GluonTrainStep: the mesh spans %d devices; the port runs the "
            "step on one device, and multi-GPU training (data, tensor or "
            "pipeline parallel over a mesh) is not yet ported" % n)
    return mesh


def put(v, device):
    """A host array or a tensor as a tensor on ``device``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(device)


def _leaves(state):
    """The tensors of an optimizer state (None, a tensor, or a tuple of
    them), in order."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _leaves(s)]


class GluonTrainStep:
    """A Gluon block, a loss and an optimizer as one training step.

    The reference's positional order: ``mesh`` third, then ``lr``,
    ``momentum``, ``wd``, ``compute_dtype``, ``param_spec_fn``,
    ``data_spec``, ``label_spec``, ``aux_loss_weight``, ``zero`` and
    ``optimizer``.  ``mesh``: None or a mesh of one device (a
    multi-device mesh raises :class:`MXNetError`).  ``device``,
    keyword-only: where the block's parameters lie and the step runs
    (``None``: ``gpu(0)``).  ``compute_dtype`` (``'bfloat16'``, ...): the
    forward and backward run on cast copies of the float32 trainables and
    of the input, while the masters and their update stay float32.
    ``optimizer``: None (SGD with momentum from ``lr``, ``momentum`` and
    ``wd``, one fused update) or a ``compiled_step_safe`` optimizer
    (module docstring; another raises :class:`MXNetError`).
    ``aux_loss_weight``: ``w`` adds ``w * block.collect_aux_losses()`` to
    the mean loss inside the step.  ``param_spec_fn``, ``data_spec``,
    ``label_spec``: sharding specs, taken and unused on the one device;
    ``zero`` raises (module docstring).  ``step(x, y)`` takes host arrays
    or tensors and returns the batch's mean loss as a tensor on the
    device, without waiting for it."""

    def __init__(self, block, loss_block, mesh=None, lr=0.1, momentum=0.9,
                 wd=0.0, compute_dtype=None, param_spec_fn=None,
                 data_spec=None, label_spec=None, aux_loss_weight=None,
                 zero=None, optimizer=None, *, device=None):
        self.block = block
        self.mesh = _one_device_mesh(mesh)
        if param_spec_fn is not None and not callable(param_spec_fn):
            raise TypeError("GluonTrainStep: param_spec_fn (the eighth "
                            "argument) must be callable, not %r; the device "
                            "is the keyword device=" % (param_spec_fn,))
        zero = zero_env_enabled() if zero is None else bool(zero)
        if zero and param_spec_fn is not None:
            raise MXNetError(
                "GluonTrainStep: zero=True owns the parameter layout "
                "(flat 1-D 'dp' shards) and cannot compose with "
                "param_spec_fn tensor sharding")
        if zero:
            raise MXNetError(
                "GluonTrainStep: zero=True (ZeRO weight-update sharding over "
                "the 'dp' axis of a device mesh) needs more than one device; "
                "the port runs the step on one device, and multi-GPU "
                "training is not yet ported")
        self.device = resolve_device(device)
        params = block.collect_params()
        for name, p in params.items():
            if is_deferred(p):
                raise MXNetError("parameter %s waits for its shape: run a "
                                 "forward of the block before building its "
                                 "step" % name)
            if p.device != self.device:
                raise MXNetError("parameter %s lives on %s, not on the "
                                 "step's device %s" % (name, p.device,
                                                       self.device))
        if param_spec_fn is not None:
            for name, p in params.items():
                param_spec_fn(name, tuple(p.shape))
        self.data_spec, self.label_spec = data_spec, label_spec
        self._names = [n for n, p in params.items() if p.grad_req != "null"]
        self.trainable = [params[n] for n in self._names]
        self.aux = [p for p in params.values() if p.grad_req == "null"]
        self._loss = loss_block
        self._aux_loss_weight = aux_loss_weight
        self.optimizer = optimizer
        if optimizer is None:
            self._update = sgd_momentum_update(lr, momentum, wd)
            self.opt_state = [torch.zeros_like(p) for p in self.trainable]
        else:
            if not getattr(optimizer, "compiled_step_safe", False):
                raise MXNetError(
                    "GluonTrainStep(optimizer=...): %s is not compiled-step "
                    "safe (its update reads per-step host scalars the step "
                    "cannot feed); SGD, NAG, Signum, Adam, Adamax, FTML, "
                    "Ftrl, RMSProp, AdaGrad and AdaDelta are"
                    % type(optimizer).__name__)
            with torch.no_grad():
                self._states = [optimizer.create_state(i, p.detach())
                                for i, p in enumerate(self.trainable)]
            self.opt_state = [t for st in self._states for t in _leaves(st)]
            self._feed = ScalarFeed(optimizer, range(len(self.trainable)),
                                    self.device)
            self._scalars = self._feed.buffer
        self._compute_dtype = _dtype(compute_dtype)
        self._capture = self.device.type == "cuda"
        self.graphs = {}  # (steps, x and y signature) -> _StepGraph
        self._graphs_cast = cast_generation()
        self.last_grad_norm = None

    def _to_device(self, x, y):
        return put(x, self.device), put(y, self.device)

    @staticmethod
    def _key(x, y, steps):
        return (steps,) + tuple((tuple(v.shape), v.dtype) for v in (x, y))

    def _graphs(self):
        """The captured graphs, dropped after a cast of any block."""
        if self._graphs_cast != cast_generation():
            self.graphs, self._graphs_cast = {}, cast_generation()
        return self.graphs

    def _graph(self, x, y, steps):
        key = self._key(x, y, steps)
        self._graphs()
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = _StepGraph(self, x, y, steps)
        return graph

    def put_batch(self, x, y):
        """The batch as tensors on the step's device: once a step at this
        signature has been captured, its graph's static inputs, filled
        with the batch (a later ``put_batch`` or step overwrites them)."""
        x, y = self._to_device(x, y)
        graph = self._graphs().get(self._key(x, y, 1))
        return graph.load(x, y) if graph is not None else (x, y)

    def _eager(self, x, y):
        """One step, eagerly: ``(loss, grad norm)``."""
        cast = self._compute_dtype
        with _capture.staging(), _autograd.record():
            override = {}
            if cast is not None:
                override = {n: p.to(cast) for n, p in zip(self._names,
                                                          self.trainable)
                            if p.dtype == torch.float32}
                x = x.to(cast)
            out = torch.func.functional_call(self.block, override, (x,))
            loss = self._loss(out, y).mean()
            if self._aux_loss_weight is not None:
                loss = loss + self._aux_loss_weight \
                    * self.block.collect_aux_losses()
        grads = torch.autograd.grad(loss, self.trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.trainable, grads)]
        with torch.no_grad():
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            if self.optimizer is None:
                self._update(self.trainable, grads, self.opt_state)
            else:
                with scalar_feed(self._feed.table):
                    for i, (w, g, st) in enumerate(zip(
                            self.trainable, grads, self._states)):
                        self.optimizer.update(i, w, g, st)
        return loss.detach(), gnorm

    def __call__(self, x, y):
        """One training step; returns the mean loss (a device tensor in
        the compute dtype, not synchronised).  ``last_grad_norm`` becomes
        the global L2 norm of the float32 gradients.  Both are fresh
        tensors."""
        x, y = self._to_device(x, y)
        if self.optimizer is not None:
            self._feed.refill(self.optimizer)
        if self._capture:
            loss, self.last_grad_norm = self._graph(x, y, 1).run(x, y)
        else:
            loss, self.last_grad_norm = self._eager(x, y)
        return loss

    def make_chained(self, n_steps):
        """``run(x, y, key=None)``: ``n_steps`` training steps on one
        batch, exactly as many ``__call__`` steps, returning the last
        loss in float32.  On the card the n steps are one captured graph,
        launched once (one ``cudaGraphLaunch``) a call; on the CPU they
        run eagerly.  ``key`` is accepted for the JAX package's signature:
        the port's random stream is its generator
        (:func:`~mxnet_tpu_torch.random.generator`).  Not with
        ``optimizer=``, as in the JAX package: its per-step scalars are
        refilled on the host before each step, which one launch of n steps
        has no room for."""
        if self.optimizer is not None:
            raise MXNetError(
                "make_chained: per-step optimizer scalars (schedules, bias "
                "corrections) are refilled host-side each step and cannot "
                "cross a chain of steps; use optimizer=None (the fused "
                "sgd-momentum closure) for chained micro-benchmarks")
        n_steps = int(n_steps)
        if n_steps < 1:
            raise MXNetError("make_chained takes at least one step, not %d"
                             % n_steps)

        def run(x, y, key=None):
            del key
            x, y = self._to_device(x, y)
            if self._capture:
                loss, self.last_grad_norm = self._graph(x, y,
                                                        n_steps).run(x, y)
                return loss.float()
            for _ in range(n_steps):
                loss, self.last_grad_norm = self._eager(x, y)
            return loss.float()

        return run

    def sync_to_params(self):
        """Nothing to do: the step updates the block's own Parameters in
        place (the JAX step keeps functional copies and writes them
        back here)."""
