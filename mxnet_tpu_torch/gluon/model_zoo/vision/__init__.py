"""Vision models of the PyTorch port: the ResNet v1 and v2 families and
VGG, and :func:`get_model` over the JAX package's table
(``mxnet_tpu/gluon/model_zoo/vision/__init__.py:13-40``)."""

from ....base import MXNetError

from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2, resnet_spec)
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn, vgg_spec)

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_resnet", "resnet18_v1",
           "resnet18_v2", "resnet34_v1", "resnet34_v2", "resnet50_v1",
           "resnet50_v2", "resnet101_v1", "resnet101_v2", "resnet152_v1",
           "resnet152_v2", "resnet_spec", "VGG", "get_vgg", "vgg11",
           "vgg11_bn", "vgg13", "vgg13_bn", "vgg16", "vgg16_bn", "vgg19",
           "vgg19_bn", "vgg_spec", "get_model"]

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
}
# the rest of the JAX table: networks not ported yet (ROADMAP Queue 1
# item 8)
_NOT_PORTED = (
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "squeezenet1.0", "squeezenet1.1", "inceptionv3", "inception_bn",
    "inception-bn", "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
    "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75",
    "mobilenetv2_0.5", "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """The network of the JAX package's table by ``name`` (any case),
    built with ``kwargs``.  A name of the table whose network is not
    ported yet raises :class:`MXNetError`; any other ``ValueError``."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError("model %s is not ported yet (ROADMAP Queue 1 item "
                         "8: alexnet, densenet, mobilenet, squeezenet, "
                         "inception)" % name)
    if name not in _MODELS:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(_MODELS) + sorted(_NOT_PORTED)))
    return _MODELS[name](**kwargs)
