"""Convolution and pooling layers of the PyTorch port.

Counterparts of ``mxnet_tpu/gluon/nn/conv_layers.py`` (its ``__all__``,
``:16-19``): ``Conv1D``/``2D``/``3D``, ``Conv1DTranspose``/``2D``/``3D``,
the max, average and global pools in 1-D, 2-D and 3-D and
``ReflectionPad2D``, with the same parameter names and shapes.  A
convolution takes the JAX layers' default channel-first layout
(``"NCW"``, ``"NCHW"``, ``"NCDHW"``: OI+spatial weights) or its
channel-last one (``"NWC"``, ``"NHWC"``, ``"NDHWC"``: O+spatial+I
weights); a transposed convolution takes the channel-first one only, as
in the JAX package (``:50-53``), with the weight (in_channels,
channels/groups, *kernel); any other layout raises
:class:`~mxnet_tpu_torch.base.MXNetError`.  Every convolution takes
``groups`` and any dilation; ``in_channels=0`` takes the input width from
the first input.  They run the registered ops' channel-last path
(:func:`~mxnet_tpu_torch.ops.nn.nchw_call`): a channel-first result is a
view with ``channels_last`` strides, so a stack of channel-first layers
copies only its first input.  On the card a 1-D or 2-D convolution's
weight-gradient, and a 1-D or 2-D transposed convolution's, runs kernels
K1a/K1b, and a 1-D or 2-D max pool's input-gradient kernel K2
(:mod:`~mxnet_tpu_torch.ops.nn`).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...ops import nn as _ops
from ..block import HybridBlock, is_deferred
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _kernel(kernel_size, nd):
    return _ops._tup(kernel_size, nd, "kernel_size")


class _Conv(HybridBlock):
    """A convolution (``op_name`` ``"Convolution"``) or transposed
    convolution (``"Deconvolution"``, ``adj`` its output padding) of
    ``len(kernel_size)`` spatial dimensions, with ``weight``
    (channels, in_channels/groups, *kernel) channel-first,
    (channels, *kernel, in_channels/groups) channel-last, or
    (in_channels, channels/groups, *kernel) transposed, and, with
    ``use_bias``, ``bias`` (channels,); ``activation`` names an
    :class:`Activation` applied after it."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 *, device=None):
        super().__init__(device=device)
        nd = len(kernel_size)
        name = type(self).__name__
        _ops._check_layout(layout, nd, name)
        self._layout = layout
        self._op_name = op_name
        self._channel_last = not _ops._channel_first(layout)
        if self._channel_last and op_name != "Convolution":
            raise MXNetError("%s: channel-last layout %r is only taken by "
                             "Convolution layers (Deconvolution is "
                             "channel-first only, as in the JAX package)"
                             % (name, layout))
        if groups < 1 or channels % groups or in_channels % groups:
            raise MXNetError("%s: groups=%s do not divide channels=%s and "
                             "in_channels=%s" % (name, groups, channels,
                                                 in_channels))
        self._kwargs = {"kernel": kernel_size,
                        "stride": _ops._tup(strides, nd, "strides"),
                        "dilate": _ops._tup(dilation, nd, "dilation"),
                        "pad": _ops._tup(padding, nd, "padding"),
                        "num_filter": channels, "num_group": groups}
        if op_name == "Convolution":
            self._kwargs["no_bias"] = not use_bias
        else:
            self._kwargs["adj"] = _ops._tup(adj, nd, "output_padding")
        self._param("weight", self._weight_shape(in_channels),
                    init=weight_initializer)
        if use_bias:
            self._param("bias", (channels,), init=bias_initializer)
        else:
            self.bias = None
        self.act = Activation(activation) if activation is not None else None

    def _weight_shape(self, in_channels):
        k, o = self._kwargs["kernel"], self._kwargs["num_filter"]
        groups = self._kwargs["num_group"]
        if self._op_name != "Convolution":
            return (in_channels, o // groups) + k
        if self._channel_last:
            return (o,) + k + (in_channels // groups,)
        return (o, in_channels // groups) + k

    def forward(self, x):
        if is_deferred(self.weight):
            self._finish_deferred(weight=self._weight_shape(
                x.shape[-1 if self._channel_last else 1]))
        if self._op_name == "Convolution":
            out = _ops.nchw_call(_ops.convolution, x, self.weight,
                                 layout=self._layout, bias=self.bias,
                                 **self._kwargs)
        else:
            out = _ops.deconvolution(x, self.weight, self.bias,
                                     **self._kwargs)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        return "%s(channels=%s, kernel=%s, stride=%s)" % (
            type(self).__name__, self._kwargs["num_filter"],
            self._kwargs["kernel"], self._kwargs["stride"])


class Conv1D(_Conv):
    """1-D convolution over NCW (the default) or NWC data, in the
    reference's argument order (conv_layers.py Conv1D)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, device=None):
        super().__init__(channels, _kernel(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device=device)


class Conv2D(_Conv):
    """2-D convolution over NCHW (the default) or NHWC data, in the
    reference's argument order (conv_layers.py Conv2D, ``:111``)."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, device=None):
        super().__init__(channels, _kernel(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device=device)


class Conv3D(_Conv):
    """3-D convolution over NCDHW (the default) or NDHWC data."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, *, device=None):
        super().__init__(channels, _kernel(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device=device)


class Conv1DTranspose(_Conv):
    """1-D transposed convolution over NCW data; ``output_padding`` is
    the op's ``adj``."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, device=None):
        super().__init__(channels, _kernel(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         device=device)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution over NCHW data."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, *, device=None):
        super().__init__(channels, _kernel(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         device=device)


class Conv3DTranspose(_Conv):
    """3-D transposed convolution over NCDHW data."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, *, device=None):
        super().__init__(channels, _kernel(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding,
                         device=device)


class _Pooling(HybridBlock):
    """Pooling (:func:`~mxnet_tpu_torch.ops.nn.pooling`) of
    ``len(pool_size)`` spatial dimensions; it holds no parameters and runs
    where its input lies, so it takes no device."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None):
        nn.Module.__init__(self)
        self.device = None
        nd = len(pool_size)
        _ops._check_layout(layout, nd, type(self).__name__)
        self._layout = layout
        self._kwargs = {"kernel": pool_size,
                        "stride": _ops._tup(pool_size if strides is None
                                            else strides, nd, "strides"),
                        "pad": _ops._tup(padding, nd, "padding"),
                        "global_pool": global_pool,
                        "pool_type": pool_type,
                        "pooling_convention": "full" if ceil_mode
                        else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return _ops.nchw_call(_ops.pooling, x, layout=self._layout,
                              **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s)" % (
            type(self).__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


class MaxPool1D(_Pooling):
    """1-D max pooling over NCW (the default) or NWC data; ``ceil_mode``
    takes the ``full`` (ceil) output size."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(_kernel(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout)


class MaxPool2D(_Pooling):
    """2-D max pooling over NCHW (the default) or NHWC data; ``ceil_mode``
    takes the ``full`` (ceil) output size."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(_kernel(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout)


class MaxPool3D(_Pooling):
    """3-D max pooling over NCDHW (the default) or NDHWC data."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(_kernel(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout)


class AvgPool1D(_Pooling):
    """1-D average pooling; ``count_include_pad`` counts the padding in
    each window's divisor."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(_kernel(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class AvgPool2D(_Pooling):
    """2-D average pooling."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_kernel(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class AvgPool3D(_Pooling):
    """3-D average pooling."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_kernel(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad)


class GlobalMaxPool1D(_Pooling):
    """The largest value over the whole width, (N, C, W) -> (N, C, 1)."""

    def __init__(self, layout="NCW"):
        super().__init__((1,), None, 0, True, True, "max", layout)


class GlobalMaxPool2D(_Pooling):
    """The largest value over the whole plane."""

    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "max", layout)


class GlobalMaxPool3D(_Pooling):
    """The largest value over the whole volume."""

    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, True, True, "max", layout)


class GlobalAvgPool1D(_Pooling):
    """The mean over the whole width."""

    def __init__(self, layout="NCW"):
        super().__init__((1,), None, 0, True, True, "avg", layout)


class GlobalAvgPool2D(_Pooling):
    """Average over the whole plane, (N, C, H, W) -> (N, C, 1, 1) (NHWC:
    (N, H, W, C) -> (N, 1, 1, C)), with the ``full`` convention as the
    JAX package's layer."""

    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "avg", layout)


class GlobalAvgPool3D(_Pooling):
    """The mean over the whole volume."""

    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, True, True, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of NCHW data on H and W (reference:
    conv_layers.py ReflectionPad2D over src/operator/pad.cc): ``padding``
    an int (every side of H and W) or the op's 8-entry ``pad_width``
    ((N lo, N hi), (C lo, C hi), (H lo, H hi), (W lo, W hi), flattened;
    N and C not padded).  It holds no parameters and takes no device."""

    def __init__(self, padding=0):
        nn.Module.__init__(self)
        self.device = None
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(int(p) for p in padding)
        if len(self._padding) != 8 or any(self._padding[:4]):
            raise MXNetError("ReflectionPad2D pads H and W only: padding %s"
                             % (padding,))

    def forward(self, x):
        p = self._padding
        return F.pad(x, (p[6], p[7], p[4], p[5]), mode="reflect")
