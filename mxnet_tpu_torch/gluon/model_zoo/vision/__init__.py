"""Vision models of the PyTorch port: the ResNet v1 family and VGG."""

from .resnet import (BasicBlockV1, BottleneckV1, ResNetV1, get_resnet,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet_spec)
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn, vgg_spec)

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet_spec", "VGG", "get_vgg", "vgg11",
           "vgg11_bn", "vgg13", "vgg13_bn", "vgg16", "vgg16_bn", "vgg19",
           "vgg19_bn", "vgg_spec"]
