"""ResNet v1 and v2 of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (reference:
python/mxnet/gluon/model_zoo/vision/resnet.py): ``BasicBlockV1``,
``BottleneckV1``, ``ResNetV1``, ``BasicBlockV2``, ``BottleneckV2``,
``ResNetV2``, ``resnet_spec``, ``get_resnet``,
``resnet{18,34,50,101,152}_v1`` and ``_v2``, and the space-to-depth stem
(``ResNetV1(stem_s2d=True)``, :class:`_S2DStem`).  The topology and the
parameter names are the JAX package's, so ``state_dict()`` keys equal its
``_collect_params_with_prefix()`` names (``features.4.0.body.0.weight``,
``features.4.0.downsample.1.running_var``, ``features.5.0.bn1.gamma``,
``features.5.0.downsample.weight``, ``output.weight``) and
:func:`~mxnet_tpu_torch.convert.load_mxnet_tpu_params` carries its
weights, the BatchNorm running statistics included.

Every constructor takes ``prefix`` and ``params`` and opens the JAX
zoo's name scopes (``mxnet_tpu/gluon/model_zoo/vision/resnet.py:55-278``),
so ``resnet50_v1(prefix="resnetv10_").collect_params()`` has the JAX
package's keys (``resnetv10_stage1_conv2d0_weight``, ...).  The v1 and v2
blocks and nets have a Symbol path (``export``); the space-to-depth stem
runs on tensors and NDArrays only, as in the JAX package.

Every constructor takes the JAX package's ``layout``: ``"NCHW"``, the
default (OIHW weights, NCHW input, BatchNorm over axis 1), or ``"NHWC"``
(OHWI weights, NHWC input, BatchNorm over axis 3); any other raises
:class:`~mxnet_tpu_torch.base.MXNetError`.  Every constructor also takes
``device`` (``None``: ``gpu(0)``).  As in the JAX
package, ``BottleneckV1``'s two 1x1 convolutions of the body carry a bias
and its 3x3 one does not.
"""

from __future__ import annotations

import torch.nn.functional as F

from ....ops import nn as _ops
from ...block import BoundOp, HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet_spec", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]

# the v1 blocks' relu after the residual sum, the v2 blocks' before each
# convolution
_RELU = BoundOp("Activation", act_type="relu")


def _conv3x3(channels, stride, in_channels, layout, device):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, layout=layout,
                  device=device)


def _bn(channels, layout, device, **kwargs):
    return BatchNorm(axis=3 if layout == "NHWC" else 1, in_channels=channels,
                     device=device, **kwargs)


def _downsample(channels, stride, in_channels, layout, device):
    ds = HybridSequential(prefix="", device=device)
    ds.add(Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                  in_channels=in_channels, layout=layout, device=device))
    ds.add(_bn(channels, layout, device))
    return ds


class _Block(HybridBlock):
    """A residual block of the port (its children are named in the
    scope it is made in, as the JAX zoo's)."""

    _port_native = True

    def __init__(self, prefix, params, device):
        super().__init__(prefix=prefix, params=params, device=device)


class BasicBlockV1(_Block):
    """18/34-layer residual block, v1 (post-activation)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, params=None, *, device=None):
        super().__init__(prefix, params, device)
        dev = device
        self.body = HybridSequential(prefix="", device=dev)
        self.body.add(_conv3x3(channels, stride, in_channels, layout, dev))
        self.body.add(_bn(channels, layout, dev))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout, dev))
        self.body.add(_bn(channels, layout, dev))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      dev) if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return _RELU(F, residual + x)


class BottleneckV1(_Block):
    """50/101/152-layer bottleneck block, v1: 1x1 (stride, bias), 3x3,
    1x1 (bias), each followed by BatchNorm."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, params=None, *, device=None):
        super().__init__(prefix, params, device)
        dev = device
        mid = channels // 4
        self.body = HybridSequential(prefix="", device=dev)
        self.body.add(Conv2D(mid, kernel_size=1, strides=stride,
                             in_channels=in_channels, layout=layout,
                             device=dev))
        self.body.add(_bn(mid, layout, dev))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, layout, dev))
        self.body.add(_bn(mid, layout, dev))
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(channels, kernel_size=1, strides=1,
                             in_channels=mid, layout=layout, device=dev))
        self.body.add(_bn(channels, layout, dev))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      dev) if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return _RELU(F, x + residual)


class BasicBlockV2(_Block):
    """18/34-layer residual block, v2 (pre-activation): BatchNorm and
    relu, then two 3x3 convolutions; the downsample convolution reads the
    pre-activated input."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, params=None, *, device=None):
        super().__init__(prefix, params, device)
        dev = device
        self.bn1 = _bn(in_channels, layout, dev)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout, dev)
        self.bn2 = _bn(channels, layout, dev)
        self.conv2 = _conv3x3(channels, 1, channels, layout, dev)
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels, layout=layout,
                                 device=dev) if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = _RELU(F, self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _RELU(F, self.bn2(x))
        return self.conv2(x) + residual


class BottleneckV2(_Block):
    """50/101/152-layer bottleneck block, v2: BatchNorm and relu before
    each of a 1x1, a 3x3 (stride) and a 1x1 convolution, none with a
    bias; the downsample convolution reads the pre-activated input."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, params=None, *, device=None):
        super().__init__(prefix, params, device)
        dev = device
        mid = channels // 4
        self.bn1 = _bn(in_channels, layout, dev)
        self.conv1 = Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                            in_channels=in_channels, layout=layout,
                            device=dev)
        self.bn2 = _bn(mid, layout, dev)
        self.conv2 = _conv3x3(mid, stride, mid, layout, dev)
        self.bn3 = _bn(mid, layout, dev)
        self.conv3 = Conv2D(channels, kernel_size=1, strides=1,
                            use_bias=False, in_channels=mid, layout=layout,
                            device=dev)
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels, layout=layout,
                                 device=dev) if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = _RELU(F, self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _RELU(F, self.bn2(x))
        x = self.conv2(x)
        x = _RELU(F, self.bn3(x))
        return self.conv3(x) + residual


class _S2DStem(_Block):
    """The 7x7/s2 stem convolution (NHWC, no bias) computed through
    space-to-depth (``mxnet_tpu/gluon/model_zoo/vision/resnet.py:179-234``):
    each 2x2 block of the input becomes 4 x in_channels channels in (dy,
    dx, c) order at half the height and width, padded (2, 1), and the
    parameter, kept at the 7x7 stem's (channels, 7, 7, in_channels)
    shape, is front-padded to 8x8 and rearranged at each forward into the
    4x4 stride-1 kernel over those channels that computes the same
    function.  Checkpoints load into either stem.  Its weight-gradient is
    K1b at I = 12 over the 4x4 taps, its input's width four times the 7x7
    stem's.  The height and width must be even (``ValueError``).  It has
    no Symbol path, as in the JAX package: export the standard stem."""

    def __init__(self, channels, in_channels=3, prefix=None, params=None, *,
                 device=None):
        super().__init__(prefix, params, device)
        self._channels = channels
        self._param("weight", (channels, 7, 7, in_channels))

    def forward(self, x):
        weight = self._parameters["weight"]
        o, c = self._channels, weight.shape[3]
        # (O, 7, 7, I) -> front-padded to 8 -> (O, 4, 2, 4, 2, I) ->
        # (O, 4, 4, 2, 2, I) -> (O, 4, 4, 4I), channels in (dy, dx, c) order
        w = F.pad(weight, (0, 0, 1, 0, 1, 0))
        w = w.reshape(o, 4, 2, 4, 2, c).permute(0, 1, 3, 2, 4, 5)
        w = w.reshape(o, 4, 4, 4 * c)
        b, h, ww, c = x.shape
        if h % 2 or ww % 2:
            raise ValueError(
                "stem_s2d needs even spatial dims, got %dx%d: pad the input "
                "or use the standard stem (the same checkpoint loads)"
                % (h, ww))
        xs = x.reshape(b, h // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        xs = xs.reshape(b, h // 2, ww // 2, 4 * c)
        # the asymmetric (2, 1) pad in s2d space is the original pad 3
        xs = F.pad(xs, (0, 0, 2, 1, 2, 1))
        return _ops.convolution(xs, w, kernel=(4, 4), stride=1, pad=0,
                                num_filter=o, no_bias=True, layout="NHWC")


def _stages(features, block, layers, channels, layout, dev):
    """``len(layers)`` stages of ``block`` appended to ``features``:
    stage i (prefix ``stage<i+1>_``) has ``layers[i]`` blocks of
    ``channels[i+1]``, its first of stride 2 (1 for the first stage) with
    a downsample where the width changes."""
    for i, num_layer in enumerate(layers):
        stride = 1 if i == 0 else 2
        stage = HybridSequential(prefix="stage%d_" % (i + 1), device=dev)
        with stage.name_scope():
            stage.add(block(channels[i + 1], stride,
                            channels[i + 1] != channels[i],
                            in_channels=channels[i], layout=layout,
                            prefix="", device=dev))
            for _ in range(num_layer - 1):
                stage.add(block(channels[i + 1], 1, False,
                                in_channels=channels[i + 1], layout=layout,
                                prefix="", device=dev))
        features.add(stage)


class ResNetV1(_Block):
    """ResNet v1: a 7x7/s2 stem with BatchNorm, relu and a 3x3/s2 max
    pool (``thumbnail``: a 3x3/s1 stem alone), ``len(layers)`` stages of
    ``block``, a global average pool and a Dense classifier of
    ``classes``.  ``channels[0]`` is the stem's width, ``channels[i+1]``
    stage i's; the input has 3 channels.  ``stem_s2d`` (NHWC only, not
    with ``thumbnail``) computes the 7x7 stem through space-to-depth
    (:class:`_S2DStem`), with the same parameter."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", stem_s2d=False,
                 prefix=None, params=None, *, device=None):
        super().__init__(prefix, params, device)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one more channel width than stages")
        if stem_s2d and layout != "NHWC":
            raise ValueError("stem_s2d requires layout='NHWC'")
        if stem_s2d and thumbnail:
            raise ValueError("stem_s2d applies to the 7x7/s2 stem; thumbnail "
                             "models have a 3x3/s1 stem")
        dev = device
        with self.name_scope():
            self.features = HybridSequential(prefix="", device=dev)
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 3, layout, dev))
            else:
                if stem_s2d:
                    self.features.add(_S2DStem(channels[0], prefix="conv0_",
                                               device=dev))
                else:
                    self.features.add(Conv2D(channels[0], 7, 2, 3,
                                             use_bias=False, in_channels=3,
                                             layout=layout, device=dev))
                self.features.add(_bn(channels[0], layout, dev))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(3, 2, 1, layout=layout))
            _stages(self.features, block, layers, channels, layout, dev)
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.output = Dense(classes, in_units=channels[-1], device=dev)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(_Block):
    """ResNet v2 (pre-activation): a BatchNorm over the raw input with
    gamma fixed at 1 and beta at 0 (``scale=False, center=False``), the
    7x7/s2 stem with BatchNorm, relu and a 3x3/s2 max pool (``thumbnail``:
    a 3x3/s1 stem alone), ``len(layers)`` stages of ``block``, then
    BatchNorm, relu, a global average pool and a Dense classifier of
    ``classes``."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", prefix=None, params=None, *,
                 device=None):
        super().__init__(prefix, params, device)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one more channel width than stages")
        dev = device
        with self.name_scope():
            self.features = HybridSequential(prefix="", device=dev)
            self.features.add(_bn(3, layout, dev, scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 3, layout, dev))
            else:
                self.features.add(Conv2D(channels[0], 7, 2, 3,
                                         use_bias=False, in_channels=3,
                                         layout=layout, device=dev))
                self.features.add(_bn(channels[0], layout, dev))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(3, 2, 1, layout=layout))
            _stages(self.features, block, layers, channels, layout, dev)
            self.features.add(_bn(channels[-1], layout, dev))
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.output = Dense(classes, in_units=channels[-1], device=dev)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_VERSIONS = {1: (ResNetV1, {"basic_block": BasicBlockV1,
                            "bottle_neck": BottleneckV1}),
             2: (ResNetV2, {"basic_block": BasicBlockV2,
                            "bottle_neck": BottleneckV2})}


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` layers; ``kwargs``
    go to :class:`ResNetV1` or :class:`ResNetV2` (``classes``,
    ``thumbnail``, ``layout``, ``prefix``, ``params``, ``device``; v1
    ``stem_s2d``)."""
    if version not in _VERSIONS:
        raise ValueError("no ResNet v%s; choose 1 or 2" % (version,))
    if num_layers not in resnet_spec:
        raise ValueError("no ResNet of %s layers; choose from %s"
                         % (num_layers, sorted(resnet_spec)))
    if pretrained:
        raise RuntimeError("pretrained weights are unavailable: load them "
                           "with load_parameters")
    net, blocks = _VERSIONS[version]
    block_type, layers, channels = resnet_spec[num_layers]
    return net(blocks[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
