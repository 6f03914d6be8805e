"""Training step of the PyTorch port built from a Gluon block.

Counterpart of ``mxnet_tpu/parallel/gluon_step.py`` ``GluonTrainStep``
(its classic path, on one device) and ``sgd_momentum_update``.  The JAX
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
   in place;
5. the running statistics, updated in place by the BatchNorm layers
   during the forward.

On the card the step is one captured CUDA graph per batch signature
(:mod:`.._capture`), the counterpart of the jitted ``_step``: the first
call at a signature warms up eagerly (its effects undone), captures the
step and replays it; every later call copies the batch into the graph's
static inputs and replays.  ``make_chained(n)`` captures n steps into one
graph, launched once.  A :meth:`~..gluon.Block.cast` of the block drops
every captured graph (they read the parameters' old storage).  On the CPU
the step runs eagerly.

The float32 masters stay the block's own Parameters, so
:meth:`GluonTrainStep.sync_to_params` has nothing to do.  ``zero=True``,
``optimizer=`` and ``param_spec_fn`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _capture
from .. import autograd as _autograd
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import cast_generation, is_deferred

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


class _StepGraph:
    """``n`` training steps at one batch signature, captured as one CUDA
    graph after an eager warm-up whose effects are undone.  ``x`` and
    ``y`` are the graph's static inputs; ``loss`` and ``grad_norm`` (the
    last step's) its static outputs."""

    def __init__(self, step, x, y, n):
        dev = step.device
        _capture.warm_up(lambda: step._eager(x, y),
                         step.trainable + step.opt_state + step.aux, dev)
        self.x, self.y = x.clone(), y.clone()

        def body():
            for _ in range(n):
                loss, gnorm = step._eager(self.x, self.y)
            return loss, gnorm

        self.graph, (self.loss, self.grad_norm) = _capture.capture(body, dev)
        self.replays = 0

    def load(self, x, y):
        """Copy a batch into the static inputs; returns them."""
        for s, v in ((self.x, x), (self.y, y)):
            if s.data_ptr() != v.data_ptr():
                s.copy_(v)
        return self.x, self.y

    def run(self, x, y):
        """Replay on ``(x, y)``: fresh copies of the loss and the grad
        norm."""
        self.load(x, y)
        self.graph.replay()
        self.replays += 1
        return self.loss.clone(), self.grad_norm.clone()


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


class GluonTrainStep:
    """A Gluon block, a loss and SGD with momentum as one training step.

    The reference's positional order: ``mesh`` third, then ``lr``,
    ``momentum``, ``wd`` and ``compute_dtype``.  ``mesh``: None or a mesh
    of one device (a multi-device mesh raises :class:`MXNetError`).
    ``device``, keyword-only: where the block's parameters lie and the
    step runs (``None``: ``gpu(0)``).  ``compute_dtype`` (``'bfloat16'``,
    ...): the forward and backward run on cast copies of the float32
    trainables and of the input, while the masters and their update stay
    float32.  ``step(x, y)`` takes host arrays or tensors and returns the
    batch's mean loss as a tensor on the device, without waiting for
    it."""

    def __init__(self, block, loss_block, mesh=None, lr=0.1, momentum=0.9,
                 wd=0.0, compute_dtype=None, *, device=None):
        self.block = block
        self.mesh = _one_device_mesh(mesh)
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
        self._names = [n for n, p in params.items() if p.grad_req != "null"]
        self.trainable = [params[n] for n in self._names]
        self.aux = [p for p in params.values() if p.grad_req == "null"]
        self.opt_state = [torch.zeros_like(p) for p in self.trainable]
        self._loss = loss_block
        self._update = sgd_momentum_update(lr, momentum, wd)
        self._compute_dtype = _dtype(compute_dtype)
        self._capture = self.device.type == "cuda"
        self.graphs = {}  # (steps, x and y signature) -> _StepGraph
        self._graphs_cast = cast_generation()
        self.last_grad_norm = None

    def _to_device(self, x, y):
        def put(v):
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            return v.to(self.device)

        return put(x), put(y)

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
        grads = torch.autograd.grad(loss, self.trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.trainable, grads)]
        with torch.no_grad():
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            self._update(self.trainable, grads, self.opt_state)
        return loss.detach(), gnorm

    def __call__(self, x, y):
        """One training step; returns the mean loss (a device tensor in
        the compute dtype, not synchronised).  ``last_grad_norm`` becomes
        the global L2 norm of the float32 gradients.  Both are fresh
        tensors."""
        x, y = self._to_device(x, y)
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
        (:func:`~mxnet_tpu_torch.random.generator`)."""
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
