"""Gluon blocks of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference:
python/mxnet/gluon/block.py).  A block is a ``torch.nn.Module`` with the
reference's naming: a ``prefix`` made by :meth:`Block.name_scope` and the
per-scope counters of ``mxnet_tpu/gluon/block.py:48-100`` (so names equal
the JAX package's letter for letter), ``params`` (a
:class:`~.parameter.ParameterDict`) and :meth:`Block.collect_params`,
keyed by the prefixed names.  ``block.weight`` is the reference's
:class:`~.parameter.Parameter` handle; its storage, an ``nn.Parameter``,
is registered in the block's ``_parameters`` under the attribute's name,
so ``state_dict()`` and :meth:`Block._collect_params_with_prefix` give
the JAX package's structural names (``encoder.layers.0.attn.qkv.weight``)
and files written by either package's ``save_parameters`` load into the
other.

A block takes tensors or NDArrays.  Tensors in give tensors out, as
``GluonTrainStep``, ``Trainer.compile`` and the server call it.  NDArrays
in give NDArrays out: the port's own layers, and any hybridized block,
unwrap them (no copy), run the tensor path, the same kernels, and wrap
the results.  A port layer's ``hybrid_forward`` runs on tensors, each
op bound to its attributes when the layer is built (:class:`BoundOp`);
a user's gets NDArrays and ``F`` = ``mx.nd`` whatever the block was
called with, as in the reference.  A
``mx.sym.Symbol`` in makes a graph (``F`` = ``mx.sym`` over the
parameters' ``var()``); :meth:`HybridBlock.export` writes it with the
parameters, and :class:`SymbolBlock` runs such a graph.  A layer of the
port without a Symbol path raises :class:`MXNetError` on a Symbol.

Parameters are made on the block's device at construction (the device
given, else the current context, :func:`~mxnet_tpu_torch.context.
current_context`; ``gpu(0)`` outside any ``with mx.cpu():``), zeros until
:meth:`Block.initialize`.  A width given as 0 makes a deferred storage
that the layer materializes from its first input's shape
(:meth:`HybridBlock.infer_shape`).

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
import functools
import re
import threading
import weakref

import numpy as np
import torch
from torch import nn

from .. import _capture
from .. import autograd as _autograd
from .. import initializer as _init
from .. import ndarray
from .. import symbol as _symbol
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray import NDArray
from ..ops import registry as _reg
from ..symbol import Symbol
from .parameter import (DeferredInitializationError, DeferredParameter,
                        Parameter, ParameterDict, ParameterTensor,
                        _bump_generation, _one_device, cast_generation,
                        is_deferred, materialize)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter",
           "ParameterTensor", "DeferredParameter", "cast_generation",
           "is_deferred", "materialize", "tensor_ops", "BoundOp"]

class _TensorOps:
    """The ``F`` a port layer's ``hybrid_forward`` gets on tensors: its
    :class:`BoundOp`s call the registered functions themselves."""

    def __getattr__(self, name):
        raise AttributeError(
            "tensor_ops has no %r: a port layer calls its ops on tensors "
            "through a BoundOp made when the layer is built" % name)

    def __repr__(self):
        return "tensor_ops"


tensor_ops = _TensorOps()


class BoundOp:
    """A registered op with a layer's attributes, for the layer's
    ``hybrid_forward``: ``op(F, *inputs)`` is ``F.<name>(*inputs,
    **attrs)``.  On tensors (``F`` is :data:`tensor_ops`) it calls the
    registered function with the attributes canonicalised once, here, so
    a tensor call parses no arguments."""

    __slots__ = ("name", "attrs", "fn")

    def __init__(self, name, **attrs):
        op = _reg.get(name)
        self.name, self.attrs = name, attrs
        self.fn = functools.partial(op.fn, **op.canonicalize_attrs(attrs))

    def __call__(self, F, *inputs):
        if F is tensor_ops:
            return self.fn(*inputs)
        return getattr(F, self.name)(*inputs, **self.attrs)


class _BlockScope:
    """Name scoping for blocks (reference: ``gluon/block.py``
    ``_BlockScope``; ``mxnet_tpu/gluon/block.py:48-100``)."""

    _current = threading.local()

    def __init__(self, block):
        # weak: a block that held its scope strongly would be a reference
        # cycle, freed (with its parameters' memory) only by the collector
        self._block = weakref.proxy(block)
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        if params is not None and not isinstance(params, ParameterDict):
            raise MXNetError("params must be a ParameterDict (another "
                             "block's .params), not %s"
                             % type(params).__name__)
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_unique(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block._params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_NAME_COUNTER = {}


def _name_unique(hint):
    count = _NAME_COUNTER.get(hint, 0)
    _NAME_COUNTER[hint] = count + 1
    return "%s%d" % (hint, count)


def _contains(args, cls):
    for a in args:
        if isinstance(a, cls):
            return True
        if isinstance(a, (list, tuple)) and _contains(a, cls):
            return True
    return False


def _unwrap(x):
    """NDArrays (in nested lists) as their tensors, no copy."""
    if isinstance(x, NDArray):
        return x.data_torch
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x):
    """Tensors (in nested lists) as NDArrays, no copy."""
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v) for v in x)
    return x


class Block(nn.Module):
    """Base of the port's layers and models (reference:
    ``gluon/block.py:127``).

    ``prefix`` and ``params`` as in the reference; ``device``: where the
    block's parameters are made (default: the current context)."""

    _active = False  # hybridized (HybridBlock.hybridize)
    _port_native = False  # a layer of the port: runs on tensors
    _symbolic = None  # takes a Symbol (None: unless a port layer's forward)
    _placeless = False  # holds no parameters: runs where its input lies

    def __init__(self, prefix=None, params=None, *, device=None):
        nn.Module.__init__(self)
        self._device_arg = device
        self._device = None
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def _alias(self):
        return type(self).__name__.lower()

    # ------------------------------------------------------------ attrs
    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        if reg is not None:
            try:
                existing = getattr(self, name)
            except AttributeError:
                existing = None
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)) and \
                    not isinstance(existing, type(value)):
                raise TypeError("Changing attribute type for %s from %s to "
                                "%s is not allowed." % (
                                    name, type(existing), type(value)))
            if isinstance(value, Parameter):
                self._register_handle(name, value)
                return
        super().__setattr__(name, value)

    def _register_handle(self, name, handle):
        """``self.<name> = handle``: the handle as the attribute, its
        storage (made on this block's device if it has none) in
        ``_parameters``."""
        storage = handle._attach(self.device if handle._storage is None
                                 else None)
        self.__dict__.pop(name, None)
        self._parameters[name] = storage
        self.__dict__[name] = handle
        self._reg_params[name] = handle
        self._shapes_known = False

    def register_child(self, block, name=None):
        """Add ``block`` as a child under ``name`` (default: the count of
        children so far)."""
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    @property
    def device(self):
        """Where the block's parameters live: its first parameter's
        device, else the device it was given or the current context
        (None for a block that runs where its input lies)."""
        for p in self._parameters.values():
            if p is not None:
                return p.device
        if self._placeless and self._device_arg is None:
            return None
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """The scope whose children take this block's prefix."""
        return self._scope

    @property
    def params(self):
        """This block's own :class:`ParameterDict` (not its children's)."""
        return self._params

    def _param(self, name, shape, dtype="float32", init=None, **kwargs):
        """``self.<name> = self.params.get(name, ...)``: a parameter of
        ``shape`` (a 0 defers a dimension to the first input) and
        ``dtype``, filled by ``init`` in :meth:`initialize` in place of
        the block-wide initializer."""
        handle = self.params.get(name, shape=shape, dtype=dtype, init=init,
                                 allow_deferred_init=True, **kwargs)
        setattr(self, name, handle)
        return handle

    def _finish_deferred(self, **shapes):
        """Materialize each deferred parameter named in ``shapes`` (name
        -> shape); a parameter that has its shape already is left
        alone."""
        for name, shape in shapes.items():
            p = self._parameters[name]
            if is_deferred(p):
                materialize(p, shape)

    # ------------------------------------------------------------ run
    def __call__(self, *args, **kwargs):
        if kwargs or not all(isinstance(a, torch.Tensor) for a in args):
            if _contains(args, Symbol) or _contains(kwargs.values(),
                                                    Symbol):
                return self._symbol_call(*args, **kwargs)
            if (self._port_native or self._active) and (
                    _contains(args, NDArray)
                    or _contains(kwargs.values(), NDArray)):
                return _wrap(self(*_unwrap(args), **{
                    k: _unwrap(v) for k, v in kwargs.items()}))
        with torch.set_grad_enabled(_autograd.is_recording()):
            if self._active and not _capture.is_staging():
                return self._hooked_cached(args, kwargs)
            return super().__call__(*args, **kwargs)

    def _symbol_call(self, *args, **kwargs):
        symbolic = self._symbolic
        if symbolic is None:
            symbolic = not (self._port_native and isinstance(
                self, HybridBlock) and type(self).forward
                is not HybridBlock.forward)
        if not symbolic:
            raise MXNetError("%s has no Symbol path: the JAX package has "
                             "none either; call it on tensors or NDArrays"
                             % type(self).__name__)
        return self.forward(*args, **kwargs)

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

    # ------------------------------------------------------------ params
    def collect_params(self, select=None):
        """Every :class:`Parameter` of this block and its descendants, by
        prefixed name, as a :class:`ParameterDict`; ``select``, a regex,
        keeps the names it matches (reference: ``Block.collect_params``)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._modules.values():
            if isinstance(child, Block):
                ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Structural name (``features.0.weight``) -> storage tensor, in
        registration order, each storage once: the names of
        ``save_parameters`` files and of ``state_dict()``."""
        return collections.OrderedDict(self.named_parameters(prefix=prefix))

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

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, seed=0):
        """Initialize every parameter (reference: ``Block.initialize``):
        by its own initializer where its layer was given one, else by its
        name's suffix: weights from ``init`` (default ``Uniform()``),
        biases and betas with zeros, gammas with ones.  ``ctx`` moves the
        parameters there first (default: where they are).  A parameter
        initialized already is left alone unless ``force_reinit``.

        The draws come from ``numpy.random.RandomState(seed)`` in
        registration order; a deferred parameter draws when it is
        materialized, from ``RandomState([seed, i])``, ``i`` its place in
        that order.  ``verbose`` is accepted and prints nothing."""
        del verbose
        rng = np.random.RandomState(seed)
        init = _init.create(init) if init is not None else _init.Uniform()
        dev = None if ctx is None else _one_device(ctx)
        done = set()
        for i, (_, p) in enumerate(self.named_parameters()):
            handle = getattr(p, "_handle", None)
            if handle is None:  # a plain nn.Parameter: not a Gluon one
                continue
            done.add(id(handle))
            handle.initialize(
                None, dev, default_init=init, force_reinit=force_reinit,
                rng=np.random.RandomState([seed, i]) if is_deferred(p)
                else rng)
        for handle in self.collect_params().values():
            if id(handle) not in done:
                handle.initialize(None, dev, default_init=init,
                                  force_reinit=force_reinit, rng=rng)
        if dev is not None:
            for b in self.modules():
                if isinstance(b, Block) and not b._placeless:
                    b._device = dev
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
        ``dtype`` in place (the handles and storages stay; gradients are
        dropped).  Every captured program of the port is dropped: its
        parent blocks' and training steps' too."""
        _bump_generation()
        dt = _dtype(dtype)
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dt)
        for handle in self._reg_params.values():
            handle.cast(dt)

    def summary(self, *inputs):
        """Print each block's output shape and parameter count for one
        forward of ``inputs`` (reference: ``Block.summary``)."""
        rows, handles = [], []

        def make_hook(path):
            def hook(block, ins, outs):
                out = outs[0] if isinstance(outs, (list, tuple)) else outs
                n = sum(int(np.prod(p.shape)) for p in
                        block._parameters.values()
                        if p is not None and not is_deferred(p))
                rows.append((path, type(block).__name__,
                             tuple(getattr(out, "shape", ())), n))
            return hook

        def attach(block, path):
            handles.append(block.register_forward_hook(make_hook(path)))
            for k, c in block.named_children():
                attach(c, path + "." + k if path else k)

        attach(self, "")
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        print("%-30s %-20s %-20s %s" % ("Layer", "Type", "Output", "Params"))
        total = 0
        for path, typ, shape, n in rows:
            total += n
            print("%-30s %-20s %-20s %d" % (path or "(self)", typ, shape, n))
        print("Total params: %d" % total)

    # ------------------------------------------------------------ save/load
    def save_parameters(self, filename):
        """Write the parameters by structural name in the npz format the
        JAX package reads, through ``checkpoint.atomic_write`` (a
        temporary file, fsync and a rename, so a crash never leaves a torn
        file under ``filename``).  Raises
        :class:`MXNetError` while a parameter's shape is deferred."""
        params = self._collect_params_with_prefix()
        deferred = [k for k, p in params.items() if is_deferred(p)]
        if deferred:
            raise MXNetError(
                "cannot save parameters %s: their shapes wait for the first "
                "input (run a forward first)" % ", ".join(deferred))
        from .. import checkpoint as _ckpt

        with _ckpt.atomic_write(filename) as tmp:
            ndarray.save(tmp, dict(params))

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Load a ``save_parameters`` file of either package (reference:
        ``Block.load_parameters``), or a legacy file keyed by the
        parameters' names (``ParameterDict.save``, with or without this
        block's prefix).  ``IOError`` on a name the file lacks unless
        ``allow_missing``, and on one this block lacks unless
        ``ignore_extra``; :class:`MXNetError` on a shape that disagrees.
        ``ctx`` moves the parameters there; ``cast_dtype`` takes the
        file's dtypes.  A deferred parameter takes the file's shape."""
        from ..convert import copy_params

        loaded = ndarray.read_npz(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if loaded and not any("." in k for k in loaded) and \
                any("." in k for k in params):
            loaded = self._legacy_names(loaded, params)
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise IOError("Parameter %s is missing in file %s"
                                  % (name, filename))
        for name in loaded:
            if name not in params and not ignore_extra:
                raise IOError("Parameter %s in file %s is not present in "
                              "this Block" % (name, filename))
        targets = {k: p for k, p in params.items() if k in loaded}
        for name, p in targets.items():
            if ctx is not None:
                p._handle.reset_ctx(ctx)
            if cast_dtype:
                p._handle.cast(loaded[name].dtype)
        copy_params(targets, {k: loaded[k] for k in targets})

    save_params = save_parameters
    load_params = load_parameters

    def _legacy_names(self, loaded, params):
        """A legacy file's arrays by structural name: its names are the
        parameters' (``collect_params()``) with or without this block's
        prefix, or, for a block whose names are its own, the structural
        ones with the prefix; a name that matches none is kept, so the
        checks report it."""
        stripped = {k.replace(self.prefix, "", 1)
                    if k.startswith(self.prefix) else k: v
                    for k, v in loaded.items()}
        if set(stripped) <= set(params):
            return stripped
        structural = {id(p): k for k, p in params.items()}
        handles = self.collect_params()
        out = {}
        for k, v in loaded.items():
            full = k if k in handles else self.prefix + k
            h = handles[full] if full in handles else None
            out[structural.get(id(h._storage), k) if h is not None
                else k] = v
        return out


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
        # weak: the block holds its graphs, and a strong link back would
        # keep both (and the graphs' memory pool) until the collector runs
        self._block = weakref.ref(block)
        self.recording = recording
        self.in_tree = in_tree
        self.device = args[0].device
        self.calls = self.replays = self.generation = 0
        self.fwd = self.bwd = None

    @property
    def block(self):
        return self._block()

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
    """A block written as ``hybrid_forward(F, x, *args, **params)``
    (reference: ``gluon/block.py:671``): ``F`` is ``mx.sym`` for a Symbol
    and ``mx.nd`` otherwise, ``params`` the block's own parameters by
    attribute name (their ``var()``s or NDArrays).  A layer of the port
    (``_port_native``) takes tensors as they are instead, with ``F`` =
    :data:`tensor_ops` and the storage tensors.  :meth:`hybridize` turns
    it into a cached program per input signature."""

    def infer_shape(self, *args):
        """Give each deferred parameter its shape from the inputs (a layer
        with deferred widths overrides it)."""
        raise NotImplementedError(
            "%s has deferred-initialized parameters whose shape could not "
            "be inferred; implement infer_shape() or initialize with full "
            "shapes." % type(self).__name__)

    _shapes_known = False  # no parameter of its own is deferred

    def _finish_shapes(self, *args):
        if self._shapes_known:
            return
        deferred = [(k, p) for k, p in self._reg_params.items()
                    if is_deferred(self._parameters[k])]
        if not deferred:
            self._shapes_known = True
            return
        self.infer_shape(*args)
        for k, p in deferred:
            if p.shape is None or 0 in p.shape:
                raise DeferredInitializationError(
                    "Parameter %s: infer_shape left its shape %s"
                    % (p.name, p.shape))
            materialize(self._parameters[k], p.shape)

    def forward(self, x, *args):
        if isinstance(x, Symbol):
            params = {k: p.var() for k, p in self._reg_params.items()}
            return self.hybrid_forward(_symbol, x, *args, **params)
        self._finish_shapes(x, *args)
        if self._port_native and not isinstance(x, NDArray):
            params = {k: self._parameters[k] for k in self._reg_params}
            return self.hybrid_forward(tensor_ops, x, *args, **params)
        # a user's block sees NDArrays and mx.nd whatever it was called
        # with (tensors: hybridized, or by the port's training steps), as
        # in the reference; its NDArray results go back as tensors
        params = {k: NDArray(self._parameters[k]) for k in self._reg_params}
        out = self.hybrid_forward(ndarray, *_wrap((x,) + args), **params)
        return out if isinstance(x, NDArray) else _unwrap(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active=True, **flags):
        """Cache one :class:`_CachedGraph` per (argument shapes, dtypes
        and gradient flags, device, train mode, recording, and the nesting
        of list arguments such as an RNN's states); ``active=False``
        runs eagerly again.  Calling it again, or :meth:`cast`, clears the
        cache.  The flags (``static_alloc``, ``static_shape``, ...) are
        accepted and change nothing: a captured graph is static in both.
        NDArray arguments are unwrapped before the cache."""
        self._active = bool(active)
        self._cached_graphs = {}
        self._graphs_cast = cast_generation()
        super().hybridize(active, **flags)

    def cast(self, dtype):
        self._cached_graphs = {}
        super().cast(dtype)

    def _graphs(self):
        """The cache, emptied after a cast or a move of this or any other
        block's parameters (the graphs read their storage)."""
        if self._graphs_cast != cast_generation():
            self._cached_graphs, self._graphs_cast = {}, cast_generation()
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

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` (the graph of a call on
        ``mx.sym.Variable("data")``) and ``path-%04d.params`` (every
        parameter as ``arg:<name>`` or ``aux:<name>``), the JAX format
        that ``SymbolBlock.imports`` and ``Module`` read (reference:
        ``HybridBlock.export``).  Returns the symbol."""
        inp = _symbol.Variable("data")
        out = self(inp)
        if isinstance(out, (list, tuple)):
            out = _symbol.Group(list(out))
        out.save("%s-symbol.json" % path)
        aux_names = set(out.list_auxiliary_states())
        arg_dict = {}
        for name, param in self.collect_params().items():
            kind = "aux" if name in aux_names else "arg"
            arg_dict["%s:%s" % (kind, name)] = \
                param._check().detach().to("cpu")
        ndarray.save("%s-%04d.params" % (path, epoch), arg_dict)
        return out


class SymbolBlock(HybridBlock):
    """A Symbol graph as a block (reference: ``gluon.SymbolBlock``,
    ``mxnet_tpu/gluon/block.py:675-754``): ``outputs`` over the
    variables ``inputs``; every other argument and auxiliary state of the
    graph is a parameter, named as in the graph, set from ``params``
    (``arg:``/``aux:`` keys or plain names) or initialized and shaped at
    the first call (:meth:`infer_shape`).

    The graph runs node by node with the registered ops
    (:func:`~mxnet_tpu_torch.executor.eval_graph`), in train mode
    updating the BatchNorm moving statistics; it is hybridized from the
    start, so on the card each input signature is one captured CUDA
    graph.  It is differentiable through PyTorch's autograd (the JAX
    package's is not: ROADMAP "deliberate divergences")."""

    _port_native = True
    _symbolic = True

    def __init__(self, outputs, inputs, params=None, *, device=None):
        super().__init__(prefix="", params=None, device=device)
        if isinstance(outputs, (list, tuple)):
            outputs = _symbol.Group(list(outputs))
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        self._arg_names = [n for n in outputs.list_arguments()
                           if n not in self._input_names]
        self._aux_names = outputs.list_auxiliary_states()
        self._nodes = outputs._topo_nodes()
        self._aux_ids = outputs._aux_nodes()
        self._attrs = {}  # device -> node attributes
        self._slots = {}  # graph name -> attribute name of its storage
        handles = [Parameter(n, allow_deferred_init=True)
                   for n in self._arg_names] + \
            [Parameter(n, grad_req="null", allow_deferred_init=True)
             for n in self._aux_names]
        params = {} if params is None else {
            k[4:] if k.startswith(("arg:", "aux:")) else k: v
            for k, v in params.items()}
        for h in handles:
            self._params._params[h.name] = h
            value = params.get(h.name)
            if value is not None:
                h.shape = tuple(value.shape)
                h.dtype = value.dtype
            slot = "p%d_%s" % (len(self._slots),
                               re.sub(r"\W", "_", h.name))
            self._slots[h.name] = slot
            setattr(self, slot, h)
            if value is not None:
                h.set_data(value)
        self.hybridize()

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A :class:`SymbolBlock` of an exported model (reference:
        ``SymbolBlock.imports``), its parameters on ``ctx`` (default: the
        current context)."""
        sym = _symbol.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [_symbol.Variable(n) for n in input_names]
        params = ndarray.read_npz(param_file) if param_file else None
        return SymbolBlock(sym, inputs, params=params, device=ctx)

    def infer_shape(self, *args):
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(
            **{n: tuple(a.shape) for n, a in zip(self._input_names, args)})
        shapes = dict(zip(self._symbol.list_arguments(), arg_shapes))
        shapes.update(zip(self._aux_names, aux_shapes))
        for name, slot in self._slots.items():
            self._reg_params[slot].shape = shapes[name]

    def forward(self, *args):
        if _contains(args, Symbol):
            return self._symbol(**dict(zip(self._input_names, args)))
        self._finish_shapes(*args)
        dev = args[0].device
        attrs = self._attrs.get(dev)
        if attrs is None:
            from ..symbol.symbol import op_attrs

            attrs = self._attrs[dev] = {id(n): op_attrs(n, dev)
                                        for n in self._nodes
                                        if not n.is_variable}
        from ..executor import eval_graph

        arg_map = dict(zip(self._input_names, args))
        arg_map.update((n, self._parameters[self._slots[n]])
                       for n in self._arg_names)
        aux_map = {n: self._parameters[self._slots[n]]
                   for n in self._aux_names}
        train = _autograd.is_training()
        outs, new_aux = eval_graph(self._symbol, self._nodes, self._aux_ids,
                                   attrs, arg_map, aux_map, train)
        if train:
            with torch.no_grad():
                for n in self._aux_names:
                    if new_aux[n] is not aux_map[n]:
                        aux_map[n].copy_(new_aux[n])
        return outs[0] if len(outs) == 1 else outs
