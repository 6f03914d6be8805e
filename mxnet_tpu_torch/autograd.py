"""Imperative autograd of the PyTorch port: record / pause / backward.

Counterpart of ``mxnet_tpu/autograd.py`` (reference:
python/mxnet/autograd.py).  The tape is PyTorch's own graph; this module
keeps MXNet's semantics on top of it:

- Recording and training are thread-local flags, as in the JAX package.
  A :class:`~mxnet_tpu_torch.gluon.Block` runs with PyTorch's grad mode
  set to the recording flag, so only recorded work is differentiable and
  :func:`backward` on an unrecorded result raises :class:`MXNetError`.
  The :func:`record` and :func:`pause` scopes also set the grad mode for
  plain tensor code inside them.
- :func:`backward` delivers gradients by each parameter's ``grad_req``:
  ``write`` overwrites ``.grad`` (in place, where a buffer exists, so
  the buffer an ``NDArray.grad`` hands out stays current), ``add`` adds
  to it (PyTorch's own ``Tensor.backward`` always adds).  A head without
  a head gradient gets ones, so a per-sample loss needs no ``.sum()``.
- Heads, head gradients and variables may be ``NDArray``s or tensors;
  :func:`mark_variables` and :func:`grad` are first-order only
  (``create_graph`` is not ported).
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "mark_variables", "grad"]

_STATE = threading.local()


def _st():
    if not hasattr(_STATE, "v"):
        _STATE.v = {"recording": False, "training": False}
    return _STATE.v


class _Scope:
    """Sets the recording and/or training flag (``None`` keeps it) for
    the scope; a set recording flag also sets PyTorch's grad mode."""

    def __init__(self, recording, training):
        self._r = recording
        self._t = training
        self._old = None
        self._grad = None

    def __enter__(self):
        st = _st()
        self._old = (st["recording"], st["training"])
        if self._r is not None:
            st["recording"] = self._r
            self._grad = torch.set_grad_enabled(self._r)
            self._grad.__enter__()
        if self._t is not None:
            st["training"] = self._t
        return self

    def __exit__(self, *exc):
        if self._grad is not None:
            self._grad.__exit__(*exc)
            self._grad = None
        st = _st()
        st["recording"], st["training"] = self._old


def record(train_mode=True):
    """``with autograd.record():`` -- record for :func:`backward` (and
    train mode unless ``train_mode=False``)."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    """Stop recording inside a :func:`record` scope."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def is_recording():
    return _st()["recording"]


def is_training():
    return _st()["training"]


def set_recording(flag):
    """Set the recording flag, which blocks follow; returns the old flag.
    PyTorch's grad mode is left as it is (only the scopes set it, and
    restore it on exit)."""
    st = _st()
    old = st["recording"]
    st["recording"] = bool(flag)
    return old


def set_training(flag):
    st = _st()
    old = st["training"]
    st["training"] = bool(flag)
    return old


def _tensor(x):
    """The tensor of an ``NDArray`` (or the tensor itself)."""
    return getattr(x, "data_torch", x)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _heads(heads, head_grads):
    """Heads and head gradients as tensors; raises for an unrecorded
    head."""
    heads = [_tensor(h) for h in _as_list(heads)]
    if head_grads is None:
        head_grads = [None] * len(heads)
    head_grads = [None if g is None else _tensor(g)
                  for g in _as_list(head_grads)]
    for h in heads:
        if not h.requires_grad:
            raise MXNetError("cannot differentiate: array is not in a "
                             "recorded graph (is autograd.record() active?)")
    return heads, [torch.ones_like(h) if g is None else g
                   for h, g in zip(heads, head_grads)]


def _autograd_grad(heads, inputs, head_grads, retain_graph):
    try:
        return torch.autograd.grad(heads, inputs, head_grads,
                                   retain_graph=retain_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        raise MXNetError("backward failed: %s" % e) from e


def _leaves(heads):
    """The leaf tensors (parameters) the heads' graphs reach, in first
    reached order (a head that is itself a leaf included)."""
    seen, leaves = set(), [h for h in heads if h.grad_fn is None]
    stack = [h.grad_fn for h in heads]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)  # AccumulateGrad
        if var is not None:
            leaves.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return leaves


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of the recorded ``heads`` into the parameters' ``.grad``.

    ``head_grads`` default to ones.  Each parameter's gradient is written
    (``grad_req='write'``, the default) or added (``'add'``); a parameter
    with ``grad_req='null'`` is not part of the graph.  Raises
    :class:`MXNetError` when a head was not recorded."""
    del train_mode  # the forward recorded the mode it ran in
    heads, head_grads = _heads(heads, head_grads)
    leaves = _leaves(heads)
    grads = _autograd_grad(heads, leaves, head_grads, retain_graph)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            if g is None:
                continue
            if p.grad is None or p.grad.shape != g.shape:
                p.grad = g
            elif getattr(p, "grad_req", "write") == "add":
                p.grad.add_(g)
            else:
                p.grad.copy_(g)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each of ``variables`` a leaf that records gradients into its
    buffer in ``gradients`` (reference: MXAutogradMarkVariables), by
    ``grad_reqs`` (one or one per variable: write, add or null)."""
    variables = _as_list(variables)
    gradients = _as_list(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, not %r"
                             % (req,))
        t, buf = _tensor(v), _tensor(g)
        if not t.is_leaf:
            raise MXNetError("mark_variables: an array computed in a "
                             "recorded graph cannot be a variable; detach() "
                             "it first")
        t.requires_grad_(req != "null")
        t.grad_req = req
        t.grad = None if req == "null" else buf


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, returned
    (as ``NDArray``s where the variables are, else tensors) and delivered
    to no ``.grad`` (reference: autograd.grad).  First order only."""
    from .ndarray.ndarray import NDArray

    del train_mode
    if create_graph:
        raise MXNetError("autograd.grad(create_graph=True): higher-order "
                         "gradients are not ported")
    heads, head_grads = _heads(heads, head_grads)
    variables = _as_list(variables)
    grads = _autograd_grad(heads, [_tensor(v) for v in variables],
                           head_grads, bool(retain_graph))
    if any(g is None for g in grads):
        raise MXNetError("one of the variables does not participate in the "
                         "graph")
    return [NDArray(g) if isinstance(v, NDArray) else g
            for v, g in zip(variables, grads)]
