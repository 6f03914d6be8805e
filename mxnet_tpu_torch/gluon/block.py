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
``lr_mult`` and ``wd_mult``.

A block runs with PyTorch's grad mode set to
:func:`~mxnet_tpu_torch.autograd.is_recording`: called outside
``autograd.record()`` it records no graph and keeps no activations, as
only recorded work is differentiable in the JAX package.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch
from torch import nn

from .. import autograd as _autograd
from .. import initializer as _init
from .. import ndarray
from ..context import resolve_device

__all__ = ["Block", "HybridBlock", "Parameter"]

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
        self.requires_grad_(req != "null")
        if req == "null":
            self.grad = None


class Block(nn.Module):
    """Base of the port's layers and models.

    ``device``: where the parameters live; ``None`` means ``gpu(0)`` and
    raises :class:`~mxnet_tpu_torch.base.MXNetError` when no CUDA device is
    present."""

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)

    def _param(self, name, shape):
        """Register a float32 parameter ``name`` of ``shape``."""
        self.register_parameter(name, Parameter(torch.zeros(
            shape, dtype=torch.float32, device=self.device)))

    def __call__(self, *args, **kwargs):
        with torch.set_grad_enabled(_autograd.is_recording()):
            return super().__call__(*args, **kwargs)

    def collect_params(self):
        """Structural name -> parameter, in registration order."""
        return collections.OrderedDict(self.named_parameters())

    def initialize(self, init=None, seed=0):
        """Fill every parameter on its device by its name's suffix:
        weights from ``init`` (default ``Uniform()``), biases and betas
        with zeros, gammas with ones.  The draws come from
        ``numpy.random.RandomState(seed)`` in registration order."""
        rng = np.random.RandomState(seed)
        init = init or _init.Uniform()
        with torch.no_grad():
            for name, p in self.named_parameters():
                arr = np.zeros(tuple(p.shape), dtype=np.float32)
                init(name, arr, rng)
                p.copy_(torch.from_numpy(arr))
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
        """Accepted for API compatibility; the port runs eagerly (CUDA
        graphs take this place in a later version)."""
        del active, kwargs

    def save_parameters(self, filename):
        """Write the parameters by structural name in the npz format the
        JAX package reads (through a temporary file and a rename, so a
        crash never leaves a torn file under ``filename``)."""
        tmp = "%s.tmp%d" % (filename, os.getpid())
        ndarray.save(tmp, {k: v for k, v in self.collect_params().items()})
        os.replace(tmp, filename)

    def load_parameters(self, filename):
        """Load a ``save_parameters`` file of either package; every name
        and shape must match (see :func:`~mxnet_tpu_torch.convert.load_mxnet_tpu_params`)."""
        from ..convert import load_mxnet_tpu_params

        load_mxnet_tpu_params(self, filename)


class HybridBlock(Block):
    """A block whose forward the JAX package can stage into one XLA
    graph; in the port it is a plain eager ``nn.Module``."""
