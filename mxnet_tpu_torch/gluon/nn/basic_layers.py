"""Basic layers of the PyTorch port.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py`` Sequential,
HybridSequential, Dense, Activation, Dropout, BatchNorm, InstanceNorm,
LayerNorm, Embedding, Flatten, Lambda and HybridLambda, with the same
parameter names, layouts and positional argument order (``prefix`` and
``params`` as keywords, ``device`` last, keyword-only).  An input width
left at 0 (``in_units``, ``in_channels``) is taken from the first input
(:meth:`~mxnet_tpu_torch.gluon.HybridBlock.infer_shape`), as in the JAX
package.  Each layer with a ``hybrid_forward`` runs the registered ops
(``F.FullyConnected``, ``F.Activation``, ``F.Dropout``, ``F.BatchNorm``,
``F.Flatten``, ``F.InstanceNorm``, ``F.LayerNorm``, ``F.Embedding``)
on tensors and NDArrays and builds their nodes on a Symbol.
"""

from __future__ import annotations

import math

import torch

from ... import autograd as _autograd
from ... import ndarray as _nd
from ...base import MXNetError
from ...ops import nn as _ops
from ..block import Block, BoundOp, HybridBlock, tensor_ops
from ..block import _dtype as _block_dtype

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation", "Dropout",
           "BatchNorm", "InstanceNorm", "LayerNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda"]


class _Stack:
    """Blocks run in order; children are named ``0``, ``1``, ...; ``len``,
    indexing (a slice gives a stack of the same kind and prefix) and
    iteration walk them."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if not isinstance(key, slice):
            return layers[key]
        net = type(self)(prefix=self._prefix, device=self._device_arg)
        net.add(*layers[key])
        return net


class Sequential(_Stack, Block):
    """A stack of blocks (reference: ``basic_layers.py:19``), run eagerly
    whatever its children are; ``hybridize()`` reaches the hybrid ones."""

    _placeless = True

    def __init__(self, prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """A stack of hybrid blocks, cached as one program by
    ``hybridize()``.  It runs on tensors (NDArrays are unwrapped at its
    call); a user's block among its children sees NDArrays all the same."""

    _port_native = True
    _placeless = True

    def __init__(self, prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)

    def hybrid_forward(self, F, x):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """``act(x @ weight.T + bias)``, weight (units, in_units), in the
    reference's argument order (``basic_layers.py:85``): ``activation``
    names an :class:`Activation` applied after the bias; ``dtype`` is the
    parameters' type; ``weight_initializer`` and ``bias_initializer``
    fill them in :meth:`~mxnet_tpu_torch.gluon.Block.initialize`."""

    _port_native = True

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._units = units
        self._flatten = flatten
        self._fc = BoundOp("FullyConnected", num_hidden=units,
                           flatten=flatten, no_bias=not use_bias)
        self._param("weight", (units, in_units), dtype, weight_initializer)
        if use_bias:
            self._param("bias", (units,), dtype, bias_initializer)
        else:
            self.bias = None
        self.act = Activation(activation, prefix=activation + "_") \
            if activation is not None else None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = self._fc(F, x, weight, bias)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        shape = self.weight.shape
        return "Dense(%s -> %s, %s)" % (
            shape[1] if shape and shape[1] else None, self._units,
            self.act if self.act is not None else "linear")


class Activation(HybridBlock):
    """Element-wise activation (:func:`~mxnet_tpu_torch.ops.nn.activation`:
    relu, sigmoid, tanh, softrelu, softsign).  It holds no parameters and
    runs where its input lies."""

    _port_native = True
    _placeless = True

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)
        self._act = BoundOp("Activation", act_type=activation)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return self._act(F, x)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class Dropout(HybridBlock):
    """Dropout of rate ``rate``: drops only in train mode
    (:func:`~mxnet_tpu_torch.autograd.is_training`, on under
    ``autograd.record()``), the identity otherwise; the mask is shared
    along ``axes``."""

    _port_native = True
    _placeless = True

    def __init__(self, rate, axes=(), prefix=None, params=None, *,
                 device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._rate = rate
        self._axes = tuple(axes)
        self._drop = BoundOp("Dropout", p=rate, axes=self._axes)

    def hybrid_forward(self, F, x):
        if self._rate == 0:
            return x
        return self._drop(F, x)

    def __repr__(self):
        return "Dropout(p = %s, axes=%s)" % (self._rate, self._axes)


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
    (``fix_gamma``) and ``center=False`` keeps beta out of training.  On
    a Symbol it is a ``BatchNorm`` node whose moving statistics the
    executor updates in train mode, as in MXNet (the JAX package's export
    fixes them: ROADMAP "deliberate divergences")."""

    _port_native = True

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        c = in_channels
        self._param("gamma", (c,), init=gamma_initializer,
                    grad_req="write" if scale else "null",
                    differentiable=scale)
        self._param("beta", (c,), init=beta_initializer,
                    grad_req="write" if center else "null",
                    differentiable=center)
        self._param("running_mean", (c,), init=running_mean_initializer,
                    grad_req="null", differentiable=False)
        self._param("running_var", (c,), init=running_variance_initializer,
                    grad_req="null", differentiable=False)

    def infer_shape(self, x, *args):
        c = (x.shape[self._axis],)
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = c

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        train_stats = _autograd.is_training() and not self._use_global_stats
        if F is not tensor_ops:
            return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                               eps=self._epsilon, momentum=self._momentum,
                               fix_gamma=not self._scale,
                               use_global_stats=self._use_global_stats,
                               axis=self._axis)
        return _ops.batch_norm(
            x, gamma, beta, running_mean, running_var,
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
        shape = self.gamma.shape
        return "BatchNorm(axis=%s, momentum=%s, eps=%s, in_channels=%s)" % (
            self._axis, self._momentum, self._epsilon,
            shape[0] if shape and shape[0] else 0)


class InstanceNorm(HybridBlock):
    """Instance normalization (reference: ``basic_layers.py``
    InstanceNorm): each sample and channel (axis 1) normalized over the
    remaining axes with the biased variance, then ``gamma`` and ``beta``;
    ``scale=False`` (the default) keeps gamma out of training and
    ``center=False`` beta.  Plain PyTorch (``F.InstanceNorm``): the JAX
    package has no kernel for it."""

    _port_native = True

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._axis = axis
        self._epsilon = epsilon
        self._norm = BoundOp("InstanceNorm", eps=epsilon)
        self._param("gamma", (in_channels,), init=gamma_initializer,
                    grad_req="write" if scale else "null")
        self._param("beta", (in_channels,), init=beta_initializer,
                    grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        c = (x.shape[self._axis],)
        self.gamma.shape = c
        self.beta.shape = c

    def hybrid_forward(self, F, x, gamma, beta):
        return self._norm(F, x, gamma, beta)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` with ``gamma`` and ``beta`` of
    ``in_channels``, the reference's argument order (``basic_layers.py:263``);
    ``center=False`` and ``scale=False`` keep beta and gamma out of
    training."""

    _port_native = True

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._axis = axis
        self._epsilon = epsilon
        self._norm = BoundOp("LayerNorm", axis=axis, eps=epsilon)
        self._param("gamma", (in_channels,), init=gamma_initializer,
                    grad_req="write" if scale else "null")
        self._param("beta", (in_channels,), init=beta_initializer,
                    grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        c = (x.shape[self._axis],)
        self.gamma.shape = c
        self.beta.shape = c

    def hybrid_forward(self, F, x, gamma, beta):
        return self._norm(F, x, gamma, beta)


class Embedding(HybridBlock):
    """Id -> row of ``weight`` (input_dim, output_dim) of ``dtype``, with
    the JAX package's index semantics
    (:func:`~mxnet_tpu_torch.ops.matrix.embedding`).  ``sparse_grad`` (a
    row-sparse gradient) is not ported and raises."""

    _port_native = True

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        if sparse_grad:
            raise MXNetError("Embedding: sparse_grad (row-sparse gradients) "
                             "is not ported")
        self._lookup = BoundOp("Embedding", input_dim=input_dim,
                               output_dim=output_dim, dtype=dtype)
        self._param("weight", (input_dim, output_dim), dtype,
                    weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return self._lookup(F, x, weight)


class Flatten(HybridBlock):
    """Every axis after the first folded into one (reference:
    ``basic_layers.py`` Flatten)."""

    _port_native = True
    _placeless = True

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._flat = BoundOp("Flatten")

    def hybrid_forward(self, F, x):
        return self._flat(F, x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """A function as a block (reference: ``basic_layers.py`` Lambda):
    ``function`` a callable, or the name of an ``mx.nd`` function."""

    _placeless = True

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            if not hasattr(_nd, function):
                raise RuntimeError("Function %s is not found in ndarray"
                                   % function)
            self._func_impl = getattr(_nd, function)
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError("function must be a str or callable")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "Lambda(%s)" % self._func_name


class HybridLambda(HybridBlock):
    """A function of ``(F, *args)`` as a hybrid block (reference:
    ``basic_layers.py`` HybridLambda): ``function`` a callable, or the
    name of an op of ``F``."""

    _placeless = True

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name = function

            def impl(F, *args):
                return getattr(F, function)(*args)

            self._func_impl = impl
        elif callable(function):
            self._func_impl = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError("function must be a str or callable")

    def hybrid_forward(self, F, *args):
        return self._func_impl(F, *args)

    def __repr__(self):
        return "HybridLambda(%s)" % self._func_name
