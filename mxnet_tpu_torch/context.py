"""Devices of the PyTorch port.

Counterpart of ``mxnet_tpu/context.py`` (reference: python/mxnet/
context.py).  A :class:`Context` names a device type and id, as in the
reference (``gpu(0)``, ``cpu()``, ``cpu_pinned()``), and stands for one
``torch.device``: ``gpu(i)`` is ``cuda:i``; ``cpu()`` and ``cpu_pinned()``
are the host.  A context compares and hashes equal to its
``torch.device``, and every entry point of the port that takes a device
(``device=``, ``ctx=``) takes a context, a ``torch.device`` or a string.

``with mx.cpu():`` makes a context the default for the scope
(:func:`current_context`): new parameters, ``mx.nd`` arrays and
DataLoader batches are made there.  Outside any scope the default is
``gpu(0)`` (unless a thread sets another, :func:`set_default`): every entry point runs on ``gpu(0)`` unless the caller or a
scope names a device, and with no CUDA device it raises
:class:`MXNetError`; it never carries on quietly on the CPU.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "gpu", "tpu", "cpu", "cpu_pinned", "current_context",
           "set_default", "num_gpus", "num_tpus", "resolve_device",
           "as_torch_device"]

_scope = threading.local()


class Context:
    """A device context (reference: ``mxnet.context.Context``):
    ``device_type`` ``'gpu'``, ``'cpu'`` or ``'cpu_pinned'`` and
    ``device_id``.  Used as ``with ctx:`` it is the scope's default
    context."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in Context.devstr2type:
            raise MXNetError("unknown device type %r; the port has %s"
                             % (device_type, ", ".join(Context.devstr2type)))
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The ``torch.device`` this context stands for."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def empty_cache(self):
        """Hand the caching allocator's free blocks on a card back to the
        driver (``torch.cuda.empty_cache``, on this context's device); a
        host context has no pool to flush (reference:
        ``Context.empty_cache``)."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()

    def __hash__(self):
        return hash(self.torch_device)

    def __eq__(self, other):
        if isinstance(other, Context):
            return (self.device_typeid, self.device_id) == \
                (other.device_typeid, other.device_id)
        if isinstance(other, torch.device):
            return self.torch_device == other
        return NotImplemented

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        stack = getattr(_scope, "stack", None)
        if stack is None:
            stack = _scope.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _scope.stack.pop()


def gpu(device_id=0):
    """The CUDA device ``device_id`` (reference: ``mx.gpu``)."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """The accelerator ``device_id``: ``gpu(device_id)`` here, so that a
    script written for the JAX package's ``mx.tpu()`` runs on the card
    (a deliberate divergence, ROADMAP Queue 3)."""
    return gpu(device_id)


def cpu(device_id=0):
    """The host (reference: ``mx.cpu``)."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """The host, for arrays staged in page-locked memory (reference:
    ``mx.cpu_pinned``)."""
    return Context("cpu_pinned", device_id)


def num_gpus():
    """The number of CUDA devices (reference: ``mx.context.num_gpus``)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus():
    """The number of accelerators: :func:`num_gpus` (see :func:`tpu`)."""
    return num_gpus()


def _scoped():
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else None


def current_context():
    """The default context: the innermost ``with ctx:`` scope's, else the
    thread's default (:func:`set_default`; ``gpu(0)`` unless set)
    (reference: ``mx.context.current_context``; its default is the card
    here, whether one is present or not)."""
    ctx = _scoped()
    if ctx is None:
        ctx = getattr(_scope, "default", None)
    return ctx if ctx is not None else gpu(0)


def set_default(ctx):
    """Make ``ctx`` (a :class:`Context`, or None for ``gpu(0)``) this
    thread's default outside any ``with`` scope (reference:
    ``test_utils.set_default_context``)."""
    _scope.default = None if ctx is None else Context(ctx)


def as_torch_device(device):
    """``device`` (a :class:`Context`, ``torch.device``, string or
    ``None`` for the current context) as a ``torch.device``, unchecked."""
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        return device.torch_device
    return torch.device(device)


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means the current
    context (:func:`current_context`: a scope's, else ``gpu(0)``).

    Raises :class:`MXNetError` when the device is a CUDA device and no
    CUDA device is present."""
    dev = as_torch_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' or run under "
            "'with mx.cpu():' to run on the host" if device is None else
            "device %s requested but no CUDA device is available" % dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
