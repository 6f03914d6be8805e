"""Basic layers of the PyTorch port.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py`` Sequential,
HybridSequential, Dense, Activation, Dropout, BatchNorm, LayerNorm and
Embedding, with the same parameter names, layouts and positional argument order (``device``
comes last, as a keyword).  An input width left at 0 (``in_units``,
``in_channels``) is taken from the first input, as the JAX package's
``infer_shape`` does: the parameter is a
:class:`~mxnet_tpu_torch.gluon.block.DeferredParameter` until then.
"""

from __future__ import annotations

import math

import torch

from ... import autograd as _autograd
from ...base import MXNetError
from ...ops import matrix as _matrix
from ...ops import nn as _ops
from ..block import Block, HybridBlock, is_deferred
from ..block import _dtype as _block_dtype

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation", "Dropout",
           "BatchNorm", "LayerNorm", "Embedding"]


class _Stack:
    """Blocks run in order; children are named ``0``, ``1``, ...; ``len``,
    indexing (a slice gives a stack of the same kind) and iteration walk
    them."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if not isinstance(key, slice):
            return layers[key]
        net = type(self)(device=self.device)
        net.add(*layers[key])
        return net


class Sequential(_Stack, Block):
    """A stack of blocks (reference: ``basic_layers.py:19``), run eagerly
    whatever its children are; ``hybridize()`` reaches the hybrid ones."""


class HybridSequential(_Stack, HybridBlock):
    """A stack of hybrid blocks, cached as one program by
    ``hybridize()``."""


class Dense(HybridBlock):
    """``act(x @ weight.T + bias)``, weight (units, in_units), in the
    reference's argument order (``basic_layers.py:85``): ``activation``
    names an :class:`Activation` applied after the bias; ``dtype`` is the
    parameters' type; ``weight_initializer`` and ``bias_initializer``
    fill them in :meth:`~mxnet_tpu_torch.gluon.Block.initialize`."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, *, device=None):
        super().__init__(device=device)
        self._units = units
        self._flatten = flatten
        self._param("weight", (units, in_units), dtype, weight_initializer)
        if use_bias:
            self._param("bias", (units,), dtype, bias_initializer)
        else:
            self.bias = None
        self.act = Activation(activation) if activation is not None else None

    def forward(self, x):
        if is_deferred(self.weight):
            in_units = math.prod(x.shape[1:]) if self._flatten \
                else x.shape[-1]
            self._finish_deferred(weight=(self._units, in_units))
        out = _ops.fully_connected(x, self.weight, self.bias,
                                   flatten=self._flatten)
        return self.act(out) if self.act is not None else out

class Activation(HybridBlock):
    """Element-wise activation (:func:`~mxnet_tpu_torch.ops.nn.activation`:
    relu).  It holds no parameters and runs where its input lies, so it
    takes no device."""

    def __init__(self, activation):
        torch.nn.Module.__init__(self)
        self.device = None
        self._act_type = activation

    def forward(self, x):
        return _ops.activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class Dropout(HybridBlock):
    """Dropout of rate ``rate``: drops only in train mode
    (:func:`~mxnet_tpu_torch.autograd.is_training`, on under
    ``autograd.record()``), the identity otherwise; the mask is shared
    along ``axes``."""

    def __init__(self, rate, axes=(), *, device=None):
        super().__init__(device=device)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        return _ops.dropout(x, p=self._rate, training=_autograd.is_training(),
                            axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` with ``gamma`` and ``beta`` and
    the running statistics ``running_mean`` and ``running_var``
    (``grad_req='null'``), float32 whatever the data's type.

    In train mode (:func:`~mxnet_tpu_torch.autograd.is_training`, on
    under ``autograd.record()``) and unless ``use_global_stats``, it
    normalizes by the batch's statistics and updates the running ones in
    place, without a gradient, once a call, as ``running * momentum +
    batch * (1 - momentum)`` with the batch's biased variance (K6a writes
    them on the card); otherwise it normalizes by the running
    statistics.  ``scale=False`` fixes gamma at 1
    (``fix_gamma``) and ``center=False`` keeps beta out of training."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, *,
                 device=None):
        super().__init__(device=device)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        c = in_channels
        for name, init in (("gamma", gamma_initializer),
                           ("beta", beta_initializer),
                           ("running_mean", running_mean_initializer),
                           ("running_var", running_variance_initializer)):
            self._param(name, (c,), init=init)
        self.gamma.grad_req = "write" if scale else "null"
        self.beta.grad_req = "write" if center else "null"
        self.running_mean.grad_req = "null"
        self.running_var.grad_req = "null"

    def forward(self, x):
        if is_deferred(self.gamma):
            c = (x.shape[self._axis],)
            self._finish_deferred(gamma=c, beta=c, running_mean=c,
                                  running_var=c)
        train_stats = _autograd.is_training() and not self._use_global_stats
        return _ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=not self._scale,
            use_global_stats=not train_stats, axis=self._axis,
            momentum=self._momentum if train_stats else None)[0]

    def cast(self, dtype):
        """Cast the layer's parameters; to a half type they stay float32,
        as in the JAX package."""
        if _block_dtype(dtype) in (torch.float16, torch.bfloat16):
            dtype = torch.float32
        super().cast(dtype)

    def __repr__(self):
        return "BatchNorm(axis=%s, momentum=%s, eps=%s, in_channels=%s)" % (
            self._axis, self._momentum, self._epsilon,
            0 if is_deferred(self.gamma) else self.gamma.shape[0])


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` with ``gamma`` and ``beta`` of
    ``in_channels``, the reference's argument order (``basic_layers.py:263``);
    ``center=False`` and ``scale=False`` keep beta and gamma out of
    training."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, *, device=None):
        super().__init__(device=device)
        self._axis = axis
        self._epsilon = epsilon
        self._param("gamma", (in_channels,), init=gamma_initializer)
        self._param("beta", (in_channels,), init=beta_initializer)
        self.gamma.grad_req = "write" if scale else "null"
        self.beta.grad_req = "write" if center else "null"

    def forward(self, x):
        if is_deferred(self.gamma):
            c = (x.shape[self._axis],)
            self._finish_deferred(gamma=c, beta=c)
        return _ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                               eps=self._epsilon)


class Embedding(HybridBlock):
    """Id -> row of ``weight`` (input_dim, output_dim) of ``dtype``, with
    the JAX package's index semantics
    (:func:`~mxnet_tpu_torch.ops.matrix.embedding`).  ``sparse_grad`` (a
    row-sparse gradient) is not ported and raises."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, *, device=None):
        super().__init__(device=device)
        if sparse_grad:
            raise MXNetError("Embedding: sparse_grad (row-sparse gradients) "
                             "is not ported")
        self._param("weight", (input_dim, output_dim), dtype,
                    weight_initializer)

    def forward(self, x):
        return _matrix.embedding(x, self.weight)
