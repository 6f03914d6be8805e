"""Gluon blocks of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/block.py`` and ``gluon/parameter.py``.
A block is a ``torch.nn.Module``; its parameters are ``nn.Parameter``s
registered under the JAX package's structural names, so
``state_dict()`` keys are the keys of the JAX package's
``Block._collect_params_with_prefix()`` (``encoder.layers.0.attn.qkv.weight``)
and files written by either package's ``save_parameters`` load into the
other.

Parameters are allocated on the block's device at construction (the
default-device rule of :mod:`..context`) and filled by
:meth:`Block.initialize` from a numpy seed.  Each is a :class:`Parameter`,
an ``nn.Parameter`` that also carries the JAX package's ``grad_req``,
``lr_mult`` and ``wd_mult``.  A width given as 0 (a layer's
``in_units=0``: the JAX package's deferred initialization,
``mxnet_tpu/gluon/parameter.py:141-158``) makes a
:class:`DeferredParameter`, PyTorch's ``UninitializedParameter``, which
the layer materializes in place from its first input's shape.

A block runs with PyTorch's grad mode set to
:func:`~mxnet_tpu_torch.autograd.is_recording`: called outside
``autograd.record()`` it records no graph and keeps no activations, as
only recorded work is differentiable in the JAX package.

``HybridBlock.hybridize()`` caches one program per input signature, as
the JAX package's ``_CachedGraph`` (``mxnet_tpu/gluon/block.py:433-523``)
stages a jitted forward and backward pair: on the card a captured CUDA
graph of the forward, and of the backward when the call records
(:mod:`.._capture`); on the CPU the block runs eagerly under the same
keys and bookkeeping.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .. import _capture
from .. import autograd as _autograd
from .. import initializer as _init
from .. import ndarray
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["Block", "HybridBlock", "Parameter", "DeferredParameter"]

_cast_generation = 0  # Block.cast calls so far
_name_counter = collections.Counter()


def _name_unique(hint):
    n = _name_counter[hint]
    _name_counter[hint] += 1
    return "%s%d" % (hint, n)


def cast_generation():
    """How many :meth:`Block.cast` calls have run.  A cast replaces the
    storage of parameters that captured programs read, so every cache of
    them (a hybridized block's, a training step's) is dropped when this
    moves."""
    return _cast_generation

class Parameter(nn.Parameter):
    """A block's weight (reference: ``gluon/parameter.py`` Parameter).

    ``grad_req``: ``'write'`` (the default:
    :func:`~mxnet_tpu_torch.autograd.backward` replaces ``.grad``),
    ``'add'`` (adds to it) or ``'null'`` (no gradient: ``requires_grad``
    is False).  ``lr_mult`` and ``wd_mult``
    scale the optimizer's learning rate and weight decay for this
    parameter."""

    lr_mult = 1.0
    wd_mult = 1.0

    @property
    def grad_req(self):
        return getattr(self, "_grad_req", "write")

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %r" % (req,))
        self._grad_req = req
        self.requires_grad = req != "null"
        if req == "null":
            self.grad = None


class DeferredParameter(UninitializedParameter, Parameter):
    """A :class:`Parameter` whose shape waits for the first input
    (reference: deferred initialization).  ``declared_shape`` holds the
    known dimensions and 0 for each unknown one.  :func:`materialize`
    turns it, the same Python object, into a :class:`Parameter`, so the
    Trainer, ``collect_params()`` and captured programs that hold it keep
    holding it; ``grad_req``, ``init``, ``lr_mult`` and ``wd_mult`` stay."""

    cls_to_become = Parameter


def materialize(p, shape):
    """Give the deferred parameter ``p`` its ``shape`` (each known
    dimension must agree) and fill it: by the initializer that
    :meth:`Block.initialize` recorded, else with zeros, as a parameter
    that was never initialized holds."""
    shape = tuple(int(s) for s in shape)
    declared = p.declared_shape
    if len(shape) != len(declared) or any(
            d and d != s for d, s in zip(declared, shape)):
        raise MXNetError("a deferred parameter of shape %s cannot take the "
                         "shape %s" % (declared, shape))
    pending = getattr(p, "_pending_init", None)
    p.materialize(shape)
    p._pending_init = None
    with torch.no_grad():
        if pending is None:
            p.zero_()
        else:
            init, name, rng = pending
            p.copy_(torch.from_numpy(_draw(p, name, init, rng)))


def _draw(p, name, init, rng):
    """``p``'s initial values: its own initializer where its layer was
    given one, else ``init`` by the name's suffix."""
    arr = np.zeros(tuple(p.shape), dtype=np.float32)
    own = getattr(p, "init", None)
    if own is None:
        init(name, arr, rng)
    else:
        _init.create(own)._init_weight(arr, rng)
    return arr


def is_deferred(p):
    """Whether ``p`` still waits for its shape."""
    return isinstance(p, DeferredParameter)


class Block(nn.Module):
    """Base of the port's layers and models.

    ``device``: where the parameters live; ``None`` means ``gpu(0)`` and
    raises :class:`~mxnet_tpu_torch.base.MXNetError` when no CUDA device is
    present."""

    _active = False  # hybridized (HybridBlock.hybridize)

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self._name = _name_unique(type(self).__name__.lower())

    @property
    def name(self):
        """The block's name: its class's, lower case, with a count a
        class (``hybridsequential0``), as the JAX package names a block
        made outside a name scope."""
        return self._name

    def _param(self, name, shape, dtype="float32", init=None):
        """Register a parameter ``name`` of ``shape`` and ``dtype``;
        ``init`` (an initializer or its name) fills it in
        :meth:`initialize` in place of the block-wide one.  A 0 in
        ``shape`` makes a :class:`DeferredParameter`."""
        dt = getattr(torch, str(dtype))
        if 0 in tuple(shape):
            p = DeferredParameter(device=self.device, dtype=dt)
            p.declared_shape = tuple(shape)
        else:
            p = Parameter(torch.zeros(shape, dtype=dt, device=self.device))
        p.init = init
        self.register_parameter(name, p)

    def _finish_deferred(self, **shapes):
        """Materialize each deferred parameter named in ``shapes`` (name ->
        shape); a parameter that has its shape already is left alone."""
        for name, shape in shapes.items():
            p = self._parameters[name]
            if is_deferred(p):
                materialize(p, shape)

    def __call__(self, *args, **kwargs):
        with torch.set_grad_enabled(_autograd.is_recording()):
            if self._active and not _capture.is_staging():
                return self._hooked_cached(args, kwargs)
            return super().__call__(*args, **kwargs)

    def _hooked_cached(self, args, kwargs):
        """A hybridized call with the block's own forward hooks around it
        (``register_forward_pre_hook``, ``register_forward_hook``; the
        JAX package's ``gluon/block.py:304-307``): they fire on every
        call, its descendants' only while the program is staged."""
        for hook in self._forward_pre_hooks.values():
            res = hook(self, args)
            if res is not None:
                args = res if isinstance(res, tuple) else (res,)
        out = self._call_cached(*args, **kwargs)
        for hook in self._forward_hooks.values():
            res = hook(self, args, out)
            if res is not None:
                out = res
        return out

    def collect_params(self):
        """Structural name -> parameter, in registration order."""
        return collections.OrderedDict(self.named_parameters())

    def collect_aux_losses(self):
        """The sum of the ``aux_loss`` of every descendant block (itself
        included) whose class publishes one (``mxnet_tpu/gluon/
        block.py:170-200``): a property holding its last forward's
        auxiliary loss.  A block reachable twice counts once.  Call it
        after the forward, in the same recording scope, or let
        ``GluonTrainStep(aux_loss_weight=w)`` add ``w`` times it to the
        loss.  Raises ``ValueError`` when no descendant publishes one."""
        total = None
        stack, seen = [self], set()
        while stack:
            b = stack.pop()
            if id(b) in seen:
                continue
            seen.add(id(b))
            if getattr(type(b), "aux_loss", None) is not None:
                total = b.aux_loss if total is None else total + b.aux_loss
            stack.extend(b.children())
        if total is None:
            raise ValueError("no descendant of %r publishes an aux_loss"
                             % (self,))
        return total

    def initialize(self, init=None, seed=0):
        """Fill every parameter on its device: by its own initializer
        where its layer was given one (``weight_initializer``, ...), else
        by its name's suffix: weights from ``init`` (default
        ``Uniform()``), biases and betas with zeros, gammas with ones.
        The draws come from
        ``numpy.random.RandomState(seed)`` in registration order; a
        deferred parameter draws when it is materialized, from
        ``RandomState([seed, i])``, ``i`` its place in that order."""
        rng = np.random.RandomState(seed)
        init = init or _init.Uniform()
        with torch.no_grad():
            for i, (name, p) in enumerate(self.named_parameters()):
                if is_deferred(p):
                    p._pending_init = (init, name,
                                       np.random.RandomState([seed, i]))
                    continue
                p.copy_(torch.from_numpy(_draw(p, name, init, rng)))
        return self

    def zero_grad(self, set_to_none=False):
        """Zero every parameter's gradient in place (the JAX package's
        ``zero_grad``); a parameter with no gradient yet keeps none."""
        del set_to_none  # gradients are zeroed, never dropped
        with torch.no_grad():
            for p in self.parameters():
                if p.grad is not None:
                    p.grad.zero_()

    def hybridize(self, active=True, **kwargs):
        """Hybridize every :class:`HybridBlock` among the children (a
        plain block has no program of its own)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter of the block and its children to
        ``dtype`` in place (the Parameter objects stay; gradients are
        dropped).  Every captured program of the port is dropped: its
        parent blocks' and training steps' too."""
        global _cast_generation
        _cast_generation += 1
        dt = _dtype(dtype)
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dt)
        for p in self._parameters.values():
            if p is not None and p.dtype != dt:
                p.data = p.data.to(dt)
                p.grad = None

    def save_parameters(self, filename):
        """Write the parameters by structural name in the npz format the
        JAX package reads (through a temporary file and a rename, so a
        crash never leaves a torn file under ``filename``).  Raises
        :class:`MXNetError` while a parameter's shape is deferred."""
        deferred = [k for k, p in self.collect_params().items()
                    if is_deferred(p)]
        if deferred:
            raise MXNetError(
                "cannot save parameters %s: their shapes wait for the first "
                "input (run a forward first)" % ", ".join(deferred))
        tmp = "%s.tmp%d" % (filename, os.getpid())
        ndarray.save(tmp, {k: v for k, v in self.collect_params().items()})
        os.replace(tmp, filename)

    def load_parameters(self, filename):
        """Load a ``save_parameters`` file of either package; every name
        and shape must match (see :func:`~mxnet_tpu_torch.convert.load_mxnet_tpu_params`)."""
        from ..convert import load_mxnet_tpu_params

        load_mxnet_tpu_params(self, filename)


def _dtype(dtype):
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(
        torch, str(np.dtype(dtype)) if str(dtype) != "bfloat16"
        else "bfloat16", None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError("cannot cast to %r" % (dtype,))
    return dt


def _flatten(out):
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (list, tuple)):
        flat, tree = [], []
        for o in out:
            f, t = _flatten(o)
            flat.extend(f)
            tree.append(t)
        return flat, tree
    raise MXNetError("a hybridized block returns tensors or (nested) lists "
                     "of them, not %s" % type(out).__name__)


def _unflatten(flat, tree):
    it = iter(flat)

    def build(t):
        return next(it) if t is None else [build(c) for c in t]

    return build(tree)


def _freeze(tree):
    """A :func:`_flatten` tree as a hashable key."""
    return None if tree is None else tuple(_freeze(t) for t in tree)


class _Replay(torch.autograd.Function):
    """A recording call of a :class:`_CachedGraph`: the forward graph's
    replay, whose backward is the backward graph's.  Inputs: the graph,
    the call's arguments, then the parameters that take a gradient."""

    @staticmethod
    def forward(ctx, graph, *tensors):
        outs = graph.replay_forward(tensors[:len(graph.static_in)])
        ctx.graph, ctx.generation = graph, graph.generation
        ctx.mark_non_differentiable(*(o for i, o in enumerate(outs)
                                      if i not in graph.grad_out))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + ctx.graph.replay_backward(ctx.generation, grads)


def _static_inputs(args, recording):
    """The graph's static inputs: copies of ``args``, normal tensors
    whatever mode the caller is in (a copy made under
    ``torch.inference_mode()`` would be an inference tensor, which a later
    call's in-place copy outside that mode may not update)."""
    with _capture.normal_tensors():
        return [a.detach().clone().requires_grad_(recording and a.requires_grad)
                for a in args]


class _CachedGraph:
    """One input signature of a hybridized block (reference: CachedOp's
    per-signature graph, ``src/imperative/cached_op.cc:266``; the JAX
    package's ``_CachedGraph``).

    On the card, the first call warms up eagerly (its effects undone),
    then captures the forward, and when the call records, the backward
    (``autograd.grad`` of the outputs with respect to the trainable
    parameters and the arguments that take a gradient), each as a CUDA
    graph on one private memory pool.  Every call, the first included,
    copies its arguments into the graph's static inputs and replays; a
    recording call returns outputs whose backward replays the backward
    graph, so ``autograd.backward`` and ``.grad`` behave as they do
    eagerly.  The outputs and gradients handed back are copies (a replay
    overwrites the graph's own): one device copy of each a call.  A
    recorded call's backward must come before the next call at the same
    signature replays the forward (its activations live in the graph):
    else it raises.  What the graph keeps is made as normal tensors
    whatever mode the first call ran under (:func:`_static_inputs`), so a
    graph captured under ``torch.inference_mode()`` replays outside it and
    the reverse.  On the CPU the block runs eagerly.  ``calls`` counts the
    calls, ``replays`` the forward replays."""

    def __init__(self, block, args, recording, in_tree):
        self.block, self.recording = block, recording
        self.in_tree = in_tree
        self.device = args[0].device
        self.calls = self.replays = self.generation = 0
        self.fwd = self.bwd = None

    def _forward(self, args):
        # the block's forward without its own hooks, which fire around
        # the call (HybridBlock._hooked_cached)
        with _capture.staging():
            return self.block.forward(*_unflatten(args, self.in_tree))

    def __call__(self, args):
        self.calls += 1
        if self.device.type != "cuda":
            return self._forward(args)
        self.prepare(args)
        if self.recording:
            outs = _Replay.apply(self, *args, *self.params)
        else:
            outs = self.replay_forward(args)
        return _unflatten(list(outs), self.tree)

    def prepare(self, args):
        """Capture the graph, once, on the card (the server builds a
        bucket so, before its first batch)."""
        if self.fwd is None and self.device.type == "cuda":
            self._capture(args)

    def _capture(self, args):
        block, dev = self.block, self.device
        self.params = [p for p in block.parameters() if p.requires_grad] \
            if self.recording else []
        state = [p for p in block.parameters() if not p.requires_grad] \
            + list(block.buffers())

        def grads_of(outs, ins):
            req = [o for o in outs if o.requires_grad]
            targets = self.params + [a for a in ins if a.requires_grad]
            if not req or not targets:
                return []
            return torch.autograd.grad(
                req, targets, [torch.ones_like(o) for o in req],
                allow_unused=True)

        def warm():
            outs, _ = _flatten(self._forward(args))
            if self.recording:
                grads_of(outs, args)

        _capture.warm_up(warm, state, dev)
        self.static_in = _static_inputs(args, self.recording)
        self.fwd, out = _capture.capture(
            lambda: self._forward(self.static_in), dev)
        self.static_out, self.tree = _flatten(out)
        if not self.recording:
            return
        self.grad_out = [i for i, o in enumerate(self.static_out)
                         if o.requires_grad]
        self.grad_in = [i for i, a in enumerate(self.static_in)
                        if a.requires_grad]
        self.static_gout = [torch.zeros_like(self.static_out[i])
                            for i in self.grad_out]
        targets = self.params + [self.static_in[i] for i in self.grad_in]
        if self.grad_out and targets:
            self.bwd, grads = _capture.capture(
                lambda: torch.autograd.grad(
                    [self.static_out[i] for i in self.grad_out], targets,
                    self.static_gout, allow_unused=True),
                dev, pool=self.fwd.pool())
        else:
            grads = [None] * len(targets)
        self.static_grads = list(grads)
        # keep the buffers, not the captured autograd graph (its nodes
        # would outlive it on the capture stream)
        self.static_out = [o.detach() for o in self.static_out]

    def replay_forward(self, args, clone=True):
        """Copy ``args`` into the static inputs and replay the forward; the
        outputs are copies, or with ``clone=False`` the graph's own
        buffers, which the next replay overwrites."""
        with torch.no_grad():
            for s, a in zip(self.static_in, args):
                if s.data_ptr() != a.data_ptr():
                    s.copy_(a)
            self.fwd.replay()
            self.replays += 1
            self.generation += 1
            if not clone:
                return list(self.static_out)
            return [o.detach().clone() for o in self.static_out]

    def replay_backward(self, generation, grads):
        if generation != self.generation:
            raise MXNetError(
                "a hybridized %s was called again at the same input "
                "signature before the backward of an earlier recorded call; "
                "its activations were overwritten (run backward first)"
                % type(self.block).__name__)
        with torch.no_grad():
            for buf, i in zip(self.static_gout, self.grad_out):
                g = grads[i]
                if g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
            if self.bwd is not None:
                self.bwd.replay()
            out = [None if g is None else g.clone()
                   for g in self.static_grads]
        n = len(self.params)
        by_arg = dict(zip(self.grad_in, out[n:]))
        return tuple(by_arg.get(i) for i in range(len(self.static_in))) \
            + tuple(out[:n])


class HybridBlock(Block):
    """A block that :meth:`hybridize` turns into a cached program per
    input signature (reference: ``gluon/block.py:671``; the JAX package's
    ``HybridBlock``).  Until then, a plain eager ``nn.Module``."""

    def hybridize(self, active=True, **flags):
        """Cache one :class:`_CachedGraph` per (argument shapes, dtypes
        and gradient flags, device, train mode, recording, and the nesting
        of list arguments such as an RNN's states); ``active=False``
        runs eagerly again.  Calling it again, or :meth:`cast`, clears the
        cache.  The flags (``static_alloc``, ``static_shape``, ...) are
        accepted and change nothing: a captured graph is static in both."""
        self._active = bool(active)
        self._cached_graphs = {}
        self._graphs_cast = _cast_generation
        super().hybridize(active, **flags)

    def cast(self, dtype):
        self._cached_graphs = {}
        super().cast(dtype)

    def _graphs(self):
        """The cache, emptied after a cast of this or any other block
        (a child's cast frees storage that this block's graphs read)."""
        if self._graphs_cast != _cast_generation:
            self._cached_graphs, self._graphs_cast = {}, _cast_generation
        return self._cached_graphs

    def _call_cached(self, *args, **kwargs):
        graph, flat = self._cached_graph(args, kwargs)
        return graph(flat)

    def _cached_graph(self, args, kwargs=None):
        """``(graph, flat arguments)``: the :class:`_CachedGraph` of the
        arguments' signature, made on its first use."""
        try:
            flat, tree = _flatten(list(args))
        except MXNetError:
            flat = None
        if kwargs or not flat:
            raise MXNetError("a hybridized %s takes tensors as positional "
                             "arguments only (or nested lists of them, as "
                             "an RNN's states)" % type(self).__name__)
        recording = _autograd.is_recording()
        key = (tuple((tuple(a.shape), a.dtype, recording and a.requires_grad)
                     for a in flat),
               flat[0].device, _autograd.is_training(), recording,
               _freeze(tree))
        graphs = self._graphs()
        graph = graphs.get(key)
        if graph is None:
            if any(is_deferred(p) for p in self.parameters()):
                # one eager pass in predict mode, unrecorded, gives the
                # deferred parameters their shapes (no dropout drawn, no
                # running statistics moved), as the JAX package's
                # _call_cached does before it stages the program
                with _autograd.pause(), _capture.staging():
                    self.forward(*args)
            graph = graphs[key] = _CachedGraph(self, flat, recording, tree)
        return graph, flat
