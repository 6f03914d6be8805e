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
  ``write`` replaces ``.grad``, ``add`` adds to it (PyTorch's own
  ``Tensor.backward`` always adds).  A head without a head gradient gets
  ones, so a per-sample loss needs no ``.sum()``.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward"]

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


def _leaves(heads):
    """The leaf tensors (parameters) the heads' graphs reach, in first
    reached order."""
    seen, leaves = set(), []
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
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    for h in heads:
        if h.grad_fn is None:
            raise MXNetError("cannot differentiate: array is not in a "
                             "recorded graph (is autograd.record() active?)")
    head_grads = [torch.ones_like(h) if g is None else g
                  for h, g in zip(heads, head_grads)]
    leaves = _leaves(heads)
    grads = torch.autograd.grad(heads, leaves, head_grads,
                                retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            if g is None:
                continue
            if getattr(p, "grad_req", "write") == "add" and p.grad is not None:
                p.grad.add_(g)
            else:
                p.grad = g
