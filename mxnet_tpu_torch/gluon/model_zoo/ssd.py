"""SSD object detectors of the PyTorch port.

- :class:`TinySSD` is the network of the JAX package's SSD example
  (``example/ssd/train.py:37-87``), with the same structural parameter
  names (``backbone.0.weight``, ``backbone.1.running_mean``, ``cls1.bias``,
  ...), so :func:`~mxnet_tpu_torch.convert.load_mxnet_tpu_params` carries
  the example's weights across.
- :class:`SSD300` is SSD300 over the reduced VGG16 of Liu et al.
  (arXiv:1512.02325) as upstream MXNet's ``example/ssd`` builds it
  (``symbol/symbol_factory.py`` ``get_config("vgg16_reduced", 300)``,
  ``symbol/vgg16_reduced.py``, ``symbol/common.py`` ``multi_layer_feature``
  and ``multibox_layer``): VGG16's ``conv1_1`` to ``conv5_3``
  (:data:`~.vision.vgg.vgg_spec` ``[16]``), ``pool3`` in ceil mode, a 3x3
  ``pool5`` of stride 1, ``fc6`` a 3x3 convolution of dilation 6 and
  ``fc7`` a 1x1 one, four extra blocks (a 1x1 convolution of half the
  width, then a 3x3 one), feature maps of 38, 19, 10, 5, 3 and 1 at a
  300 x 300 input, ``relu4_3`` L2-normalized over the channels times a
  learned scale that starts at 20, and 8,732 anchors.  ``width_divisor``
  divides every width but the heads' (the CPU tests run it narrow).

Both take NCHW images, the Gluon layers' default layout, and return
``(anchor (1, N, 4), cls_pred (B, N, classes + 1), loc_pred (B, N * 4))``.
:func:`cls_loss` is the example's class loss (``train.py:162-170``);
:func:`synthetic_scenes` makes the example's kind of scenes for any
number of classes (``make_scenes``, ``train.py:93``), one colour a class,
and :func:`normalize` applies ``ImageDetIter``'s ``mean=True`` and
``std=True`` constants.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ... import initializer
from ...ops import contrib as _contrib
from ...ops import matrix as _matrix
from ...ops import nn as _ops
from ..block import Block
from ..nn import Activation, BatchNorm, Conv2D, MaxPool2D, Sequential
from .vision.vgg import vgg_spec

__all__ = ["TinySSD", "SSD300", "SSD300_CONFIG", "multibox_heads",
           "cls_loss", "synthetic_scenes", "normalize", "COLOURS"]

# get_config("vgg16_reduced", 300): the maps' sizes, ratios and steps, the
# extra blocks' widths, strides and pads
SSD300_CONFIG = dict(
    sizes=[[.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79],
           [.88, .961]],
    ratios=[[1, 2, .5]] + [[1, 2, .5, 3, 1. / 3]] * 3 + [[1, 2, .5]] * 2,
    steps=[s / 300.0 for s in (8, 16, 32, 64, 100, 300)],
    extra_filters=[512, 256, 256, 256], extra_strides=[2, 2, 1, 1],
    extra_pads=[1, 1, 0, 0], normalization=20.0)


def multibox_heads(feats, cls_heads, loc_heads, sizes, ratios, steps,
                   num_classes):
    """Anchors and the heads' predictions of each feature map, concatenated
    over the maps (``common.py`` ``multibox_layer``).  A head's NCHW result
    lies ``channels_last`` in memory, so its (B, H, W, C) permute is
    contiguous and the reshape free; the concatenation is the one copy."""
    anchors, cls_preds, loc_preds = [], [], []
    for i, f in enumerate(feats):
        anchors.append(_contrib.multibox_prior(
            f, sizes=sizes[i], ratios=ratios[i],
            steps=(steps[i], steps[i]) if steps else (-1.0, -1.0)))
        b = f.shape[0]
        cls_preds.append(cls_heads[i](f).permute(0, 2, 3, 1).reshape(
            b, -1, num_classes + 1))
        loc_preds.append(loc_heads[i](f).permute(0, 2, 3, 1).reshape(b, -1))
    return (torch.cat(anchors, dim=1), torch.cat(cls_preds, dim=1),
            torch.cat(loc_preds, dim=1))


# a class's box colour: levels 90, 165 and 240 of each channel, grey
# left out, so any two differ by 75 in a channel over noise of 0-40
COLOURS = [c for c in itertools.product((240, 165, 90), repeat=3)
           if len(set(c)) > 1][:20]
_MEAN = (123.68, 116.28, 103.53)   # ImageDetIter's mean=True
_STD = (58.395, 57.12, 57.375)     # and std=True, RGB


def synthetic_scenes(rng, n, hw, num_classes, max_objs=1):
    """``n`` scenes as uint8 NCHW images (n, 3, hw, hw) of noise in [0, 40)
    with 1 to ``max_objs`` disjoint solid boxes of ``hw / 4`` to ``hw /
    2`` a side, the colour of a box its class (:data:`COLOURS`), and
    labels (n, max_objs, 5) [class, x1, y1, x2, y2] in [0, 1], padded
    with -1: the example's ``make_scenes``, from ``rng`` (a numpy
    ``RandomState``)."""
    if num_classes > len(COLOURS):
        raise ValueError("synthetic_scenes has %d colours, not %d"
                         % (len(COLOURS), num_classes))
    images = (rng.rand(n, hw, hw, 3) * 40).astype(np.uint8)
    label = -np.ones((n, max_objs, 5), np.float32)
    for i in range(n):
        placed = []
        for _ in range(rng.randint(1, max_objs + 1)):
            cls = rng.randint(num_classes)
            w, h = rng.randint(hw // 4, hw // 2, 2)
            x0, y0 = rng.randint(0, hw - w), rng.randint(0, hw - h)
            if any(x0 < px1 and px0 < x0 + w and y0 < py1 and py0 < y0 + h
                   for px0, py0, px1, py1 in placed):
                continue
            images[i, y0:y0 + h, x0:x0 + w] = COLOURS[cls]
            label[i, len(placed)] = [cls, x0 / hw, y0 / hw, (x0 + w) / hw,
                                     (y0 + h) / hw]
            placed.append((x0, y0, x0 + w, y0 + h))
    return np.ascontiguousarray(images.transpose(0, 3, 1, 2)), label


def normalize(images):
    """uint8 NCHW images as float32, less ``ImageDetIter``'s mean, over its
    standard deviation, on the images' device."""
    shape = (1, 3, 1, 1)
    mean = torch.tensor(_MEAN, device=images.device).reshape(shape)
    std = torch.tensor(_STD, device=images.device).reshape(shape)
    return (images.to(torch.float32) - mean) / std


def cls_loss(cls_pred, cls_t):
    """Cross-entropy of ``cls_pred`` (B, N, classes + 1) against the
    targets ``cls_t`` (B, N) of MultiBoxTarget, averaged over the anchors
    whose target is not negative (hard-negative mining marks the rest
    ignored), as the JAX example's ``cls_loss_fn``."""
    log_p = _ops.log_softmax(cls_pred, axis=-1)
    ce = -_matrix.pick(log_p, cls_t.clamp(0, 1e9), axis=-1)
    valid = (cls_t >= 0).to(torch.float32)
    return (ce * valid).sum() / valid.sum().clamp(1.0, 1e18)


class TinySSD(Block):
    """The JAX example's scaled SSD: two conv-BN-ReLU-pool stages, a
    conv-BN-ReLU scale and a downsampled one, a class and a box head of
    3x3 convolutions on each (``SIZES``, ``RATIOS``: 4 anchors a
    position)."""

    SIZES = [(0.2, 0.27), (0.45, 0.55)]
    RATIOS = [(1.0, 2.0, 0.5)] * 2

    def __init__(self, num_classes=3, *, device=None):
        super().__init__(device=device)
        dev = self.device
        self.num_classes = num_classes
        self.num_anchors = len(self.SIZES[0]) + len(self.RATIOS[0]) - 1

        def conv_bn(f):
            return [Conv2D(f, 3, padding=1, device=dev),
                    BatchNorm(device=dev), Activation("relu")]

        self.backbone = Sequential(device=dev)
        for f in (16, 32):
            self.backbone.add(*conv_bn(f), MaxPool2D(2))
        self.scale1 = Sequential(device=dev)
        self.scale1.add(*conv_bn(32))
        self.down = Sequential(device=dev)
        self.down.add(*conv_bn(32), MaxPool2D(2))
        a, c = self.num_anchors, num_classes
        self.cls1 = Conv2D(a * (c + 1), 3, padding=1, device=dev)
        self.loc1 = Conv2D(a * 4, 3, padding=1, device=dev)
        self.cls2 = Conv2D(a * (c + 1), 3, padding=1, device=dev)
        self.loc2 = Conv2D(a * 4, 3, padding=1, device=dev)

    def forward(self, x):
        f1 = self.scale1(self.backbone(x))
        f2 = self.down(f1)
        return multibox_heads([f1, f2], [self.cls1, self.cls2],
                              [self.loc1, self.loc2], self.SIZES, self.RATIOS,
                              None, self.num_classes)


class SSD300(Block):
    """SSD300 over the reduced VGG16 (see the module's text): ``features``
    runs ``conv1_1`` to ``relu4_3``, ``fc`` runs ``pool4`` to ``relu7``,
    ``l2_scale`` (1, C, 1, 1) scales the normalized ``relu4_3``,
    ``extras`` holds the four extra blocks, and ``cls_heads`` and
    ``loc_heads`` one 3x3 convolution each a map."""

    def __init__(self, num_classes=20, width_divisor=1, *, device=None):
        super().__init__(device=device)
        dev = self.device
        cfg = SSD300_CONFIG
        self.num_classes = num_classes
        layers, filters = vgg_spec[16]
        widths = [f // width_divisor for f in filters]

        def conv(f, k=3, stride=1, pad=1, dilation=1):
            return [Conv2D(f, k, strides=stride, padding=pad,
                           dilation=dilation, device=dev),
                    Activation("relu")]

        self.features = Sequential(device=dev)
        for stage in range(4):
            if stage:
                # pool3 in ceil mode: 75 -> 38
                self.features.add(MaxPool2D(2, 2, ceil_mode=stage == 3))
            for _ in range(layers[stage]):
                self.features.add(*conv(widths[stage]))
        fc = 1024 // width_divisor
        self.fc = Sequential(device=dev)
        self.fc.add(MaxPool2D(2, 2))
        for _ in range(layers[4]):
            self.fc.add(*conv(widths[4]))
        self.fc.add(MaxPool2D(3, 1, 1))
        self.fc.add(*conv(fc, pad=6, dilation=6), *conv(fc, k=1, pad=0))
        self._param("l2_scale", (1, widths[3], 1, 1),
                    init=initializer.Constant(cfg["normalization"]))
        self.extras = Sequential(device=dev)
        for f, s, p in zip(cfg["extra_filters"], cfg["extra_strides"],
                           cfg["extra_pads"]):
            f //= width_divisor
            block = Sequential(device=dev)
            block.add(*conv(f // 2, k=1, pad=0), *conv(f, stride=s, pad=p))
            self.extras.add(block)
        self.cls_heads = Sequential(device=dev)
        self.loc_heads = Sequential(device=dev)
        for sizes, ratios in zip(cfg["sizes"], cfg["ratios"]):
            a = len(sizes) + len(ratios) - 1
            self.cls_heads.add(Conv2D(a * (num_classes + 1), 3, padding=1,
                                      device=dev))
            self.loc_heads.add(Conv2D(a * 4, 3, padding=1, device=dev))

    def forward(self, x):
        x = self.features(x)
        feats = [_ops.l2_normalization(x, mode="channel") * self.l2_scale]
        x = self.fc(x)
        feats.append(x)
        for block in self.extras:
            x = block(x)
            feats.append(x)
        cfg = SSD300_CONFIG
        return multibox_heads(feats, self.cls_heads, self.loc_heads,
                              cfg["sizes"], cfg["ratios"], cfg["steps"],
                              self.num_classes)
