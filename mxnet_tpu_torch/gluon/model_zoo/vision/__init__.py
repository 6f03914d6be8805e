"""Vision models of the PyTorch port: the ResNet v1 family."""

from .resnet import (BasicBlockV1, BottleneckV1, ResNetV1, get_resnet,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet_spec)

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet_spec"]
