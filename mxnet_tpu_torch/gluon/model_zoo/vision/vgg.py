"""VGG of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py`` (reference:
python/mxnet/gluon/model_zoo/vision/vgg.py, after Simonyan and Zisserman,
arXiv:1409.1556): ``VGG``, ``vgg_spec``, ``get_vgg`` and
``vgg{11,13,16,19}`` with their ``_bn`` forms, in the JAX package's
layout (NCHW data, OIHW weights) and with its structural parameter names
(``features.0.weight``, ``features.1.gamma`` in the ``_bn`` forms,
``output.weight``), so :func:`~mxnet_tpu_torch.convert.load_mxnet_tpu_params`
carries its weights.  The convolutions' and the first dense layer's input
widths are deferred to the first input, as in the JAX package.
``pretrained=True`` raises, as it does there: no weights are at hand.
"""

from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Dropout,
                   HybridSequential, MaxPool2D)

__all__ = ["VGG", "vgg_spec", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]

# layers: convolutions a stage; filters: their widths
vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    """Stages of 3x3 convolutions (each with ReLU, BatchNorm before it in
    the ``_bn`` forms) and a 2x2 max pool, then two dense layers of 4096
    with ReLU and dropout 0.5, then ``output`` over ``classes``."""

    _port_native = True

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        if len(layers) != len(filters):
            raise ValueError("VGG takes one width a stage: %s layers, %s "
                             "filters" % (layers, filters))
        dev = self._device_arg
        with self.name_scope():
            self.features = HybridSequential(prefix="", device=dev)
            for num, width in zip(layers, filters):
                for _ in range(num):
                    self.features.add(Conv2D(width, kernel_size=3, padding=1,
                                             device=dev))
                    if batch_norm:
                        self.features.add(BatchNorm(device=dev))
                    self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(strides=2))
            for _ in range(2):
                self.features.add(Dense(4096, activation="relu",
                                        weight_initializer="normal",
                                        bias_initializer="zeros",
                                        device=dev))
                self.features.add(Dropout(rate=0.5, device=dev))
            self.output = Dense(classes, weight_initializer="normal",
                                bias_initializer="zeros", device=dev)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """VGG of ``num_layers`` (11, 13, 16 or 19) layers; ``ctx`` and
    ``root`` are accepted and ignored (``device`` places it)."""
    del ctx, root
    if num_layers not in vgg_spec:
        raise ValueError("no VGG of %s layers; choose from %s"
                         % (num_layers, sorted(vgg_spec)))
    if pretrained:
        raise RuntimeError("pretrained weights unavailable: no network "
                           "egress")
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
