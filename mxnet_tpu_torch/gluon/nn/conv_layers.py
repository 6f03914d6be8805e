"""Convolution and pooling layers of the PyTorch port.

Counterparts of ``mxnet_tpu/gluon/nn/conv_layers.py`` ``_Conv``,
``Conv2D``, ``_Pooling``, ``MaxPool2D`` and ``GlobalAvgPool2D``, with
the same parameter names and shapes.  Each takes the JAX layers' default
layout, ``"NCHW"`` (OIHW weights), or ``"NHWC"`` (OHWI weights); any
other raises :class:`~mxnet_tpu_torch.base.MXNetError`.  Both run the
registered ops' NHWC path (:func:`~mxnet_tpu_torch.ops.nn.nchw_call`):
an NCHW result is a view with ``channels_last`` strides, so a stack of
NCHW layers copies only its first input.  Convolutions take any dilation
and groups 1; ``in_channels=0`` takes the input width from the first
input.  On the card a convolution's weight-gradient runs kernels K1a/K1b
and a max pool's input-gradient kernel K2 (:mod:`~mxnet_tpu_torch.ops.nn`).
"""

from __future__ import annotations

from torch import nn

from ...base import MXNetError
from ...ops import nn as _ops
from ..block import HybridBlock, is_deferred
from .basic_layers import Activation

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


class _Conv(HybridBlock):
    """A 2-D convolution with ``weight`` (channels, in_channels, KH, KW)
    in NCHW, (channels, KH, KW, in_channels) in NHWC, and, with
    ``use_bias``, ``bias`` (channels,); ``activation`` names an
    :class:`Activation` applied after it."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", *, device=None):
        super().__init__(device=device)
        _ops._check_2d_layout(layout, type(self).__name__)
        self._layout = layout
        self._kwargs = {"kernel": _ops._pair(kernel_size, "kernel_size"),
                        "stride": _ops._pair(strides, "strides"),
                        "dilate": _ops._pair(dilation, "dilation"),
                        "pad": _ops._pair(padding, "padding"),
                        "num_filter": channels,
                        "num_group": groups, "no_bias": not use_bias}
        if groups != 1:
            raise MXNetError("%s: the port takes groups=1"
                             % type(self).__name__)
        self._param("weight", self._weight_shape(in_channels),
                    init=weight_initializer)
        if use_bias:
            self._param("bias", (channels,), init=bias_initializer)
        else:
            self.bias = None
        self.act = Activation(activation) if activation is not None else None

    def _weight_shape(self, in_channels):
        k, o = self._kwargs["kernel"], self._kwargs["num_filter"]
        if self._layout == "NHWC":
            return (o,) + k + (in_channels,)
        return (o, in_channels) + k

    def forward(self, x):
        if is_deferred(self.weight):
            self._finish_deferred(weight=self._weight_shape(
                x.shape[-1 if self._layout == "NHWC" else 1]))
        out = _ops.nchw_call(_ops.convolution, x, self.weight,
                             layout=self._layout, bias=self.bias,
                             **self._kwargs)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        return "%s(channels=%s, kernel=%s, stride=%s)" % (
            type(self).__name__, self._kwargs["num_filter"],
            self._kwargs["kernel"], self._kwargs["stride"])


class Conv2D(_Conv):
    """2-D convolution over NCHW (the default) or NHWC data, in the
    reference's argument order (conv_layers.py Conv2D, ``:111``)."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, device=None):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, device=device)


class _Pooling(HybridBlock):
    """Pooling (:func:`~mxnet_tpu_torch.ops.nn.pooling`); it holds no
    parameters and runs where its input lies, so it takes no device."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout):
        nn.Module.__init__(self)
        self.device = None
        _ops._check_2d_layout(layout, type(self).__name__)
        self._layout = layout
        self._kwargs = {"kernel": _ops._pair(pool_size, "pool_size"),
                        "stride": _ops._pair(pool_size if strides is None
                                             else strides, "strides"),
                        "pad": _ops._pair(padding, "padding"),
                        "global_pool": global_pool,
                        "pool_type": pool_type,
                        "pooling_convention": "full" if ceil_mode
                        else "valid"}

    def forward(self, x):
        return _ops.nchw_call(_ops.pooling, x, layout=self._layout,
                              **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s)" % (
            type(self).__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


class MaxPool2D(_Pooling):
    """2-D max pooling over NCHW (the default) or NHWC data; ``ceil_mode``
    takes the ``full`` (ceil) output size."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout)


class GlobalAvgPool2D(_Pooling):
    """Average over the whole plane, (N, C, H, W) -> (N, C, 1, 1) (NHWC:
    (N, H, W, C) -> (N, 1, 1, C)), with the ``full`` convention as the
    JAX package's layer."""

    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "avg", layout)
