"""Vision models of the PyTorch port: the ResNet v1 and v2 families and
VGG."""

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
           "vgg19_bn", "vgg_spec"]
