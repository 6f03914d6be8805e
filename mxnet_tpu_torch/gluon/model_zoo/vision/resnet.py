"""ResNet v1 of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (reference:
python/mxnet/gluon/model_zoo/vision/resnet.py) for the v1 family:
``BasicBlockV1``, ``BottleneckV1``, ``ResNetV1``, ``resnet_spec``,
``get_resnet`` and ``resnet{18,34,50,101,152}_v1``.  The topology and the
parameter names are the JAX package's, so ``state_dict()`` keys equal its
``_collect_params_with_prefix()`` names (``features.4.0.body.0.weight``,
``features.4.0.downsample.1.running_var``, ``output.weight``) and
:func:`~mxnet_tpu_torch.convert.load_mxnet_tpu_params` carries its
weights, the BatchNorm running statistics included.

Every constructor takes the JAX package's ``layout``: ``"NCHW"``, the
default (OIHW weights, NCHW input, BatchNorm over axis 1), or ``"NHWC"``
(OHWI weights, NHWC input, BatchNorm over axis 3); any other raises
:class:`~mxnet_tpu_torch.base.MXNetError`.  Every constructor also takes
``device`` (``None``: ``gpu(0)``).  As in the JAX
package, ``BottleneckV1``'s two 1x1 convolutions of the body carry a bias
and its 3x3 one does not.
"""

from __future__ import annotations

from ....ops import nn as _ops
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "resnet_spec",
           "get_resnet", "resnet18_v1", "resnet34_v1", "resnet50_v1",
           "resnet101_v1", "resnet152_v1"]


def _conv3x3(channels, stride, in_channels, layout, device):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, layout=layout,
                  device=device)


def _bn(channels, layout, device):
    return BatchNorm(axis=3 if layout == "NHWC" else 1, in_channels=channels,
                     device=device)


def _downsample(channels, stride, in_channels, layout, device):
    ds = HybridSequential(device=device)
    ds.add(Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                  in_channels=in_channels, layout=layout, device=device))
    ds.add(_bn(channels, layout, device))
    return ds


class BasicBlockV1(HybridBlock):
    """18/34-layer residual block, v1 (post-activation)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None):
        super().__init__(device=device)
        dev = self.device
        self.body = HybridSequential(device=dev)
        self.body.add(_conv3x3(channels, stride, in_channels, layout, dev))
        self.body.add(_bn(channels, layout, dev))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout, dev))
        self.body.add(_bn(channels, layout, dev))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      dev) if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return _ops.activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    """50/101/152-layer bottleneck block, v1: 1x1 (stride, bias), 3x3,
    1x1 (bias), each followed by BatchNorm."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None):
        super().__init__(device=device)
        dev = self.device
        mid = channels // 4
        self.body = HybridSequential(device=dev)
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

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return _ops.activation(x + residual, act_type="relu")


class ResNetV1(HybridBlock):
    """ResNet v1: a 7x7/s2 stem with BatchNorm, relu and a 3x3/s2 max
    pool (``thumbnail``: a 3x3/s1 stem alone), ``len(layers)`` stages of
    ``block``, a global average pool and a Dense classifier of
    ``classes``.  ``channels[0]`` is the stem's width, ``channels[i+1]``
    stage i's; the input has 3 channels."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", device=None):
        super().__init__(device=device)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one more channel width than stages")
        dev = self.device
        self.features = HybridSequential(device=dev)
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 3, layout, dev))
        else:
            self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                     in_channels=3, layout=layout,
                                     device=dev))
            self.features.add(_bn(channels[0], layout, dev))
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            stage = HybridSequential(device=dev)
            stage.add(block(channels[i + 1], stride,
                            channels[i + 1] != channels[i],
                            in_channels=channels[i], layout=layout,
                            device=dev))
            for _ in range(num_layer - 1):
                stage.add(block(channels[i + 1], 1, False,
                                in_channels=channels[i + 1], layout=layout,
                                device=dev))
            self.features.add(stage)
        self.features.add(GlobalAvgPool2D(layout=layout))
        self.output = Dense(classes, in_units=channels[-1], device=dev)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``version`` (1 only in the port) of ``num_layers`` layers;
    ``kwargs`` go to :class:`ResNetV1` (``classes``, ``thumbnail``,
    ``layout``, ``device``)."""
    if version != 1:
        raise ValueError("the port has ResNet v1 only, not v%s" % version)
    if num_layers not in resnet_spec:
        raise ValueError("no ResNet of %s layers; choose from %s"
                         % (num_layers, sorted(resnet_spec)))
    if pretrained:
        raise RuntimeError("pretrained weights are unavailable: load them "
                           "with load_parameters")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


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
