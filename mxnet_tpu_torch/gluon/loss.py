"""Gluon losses of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference:
python/mxnet/gluon/loss.py): ``Loss``, ``L2Loss``, ``L1Loss``,
``SigmoidBinaryCrossEntropyLoss`` (alias ``SigmoidBCELoss``),
``SoftmaxCrossEntropyLoss`` (alias ``SoftmaxCELoss``), ``KLDivLoss``,
``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``, ``LogisticLoss``,
``TripletLoss``, ``CosineEmbeddingLoss`` and ``CTCLoss``, each in the
JAX package's arithmetic.  A loss returns the per-sample loss: the mean
over every axis but ``batch_axis`` (``TripletLoss`` and
``CosineEmbeddingLoss``: one value a sample; ``CTCLoss``: one a
sequence).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import matrix as _matrix
from ..ops import nn as _ops
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss", "CTCLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """Weigh the element-wise loss by ``sample_weight`` (broadcast) and
    the scalar ``weight``."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _mean_all_but_batch(loss, batch_axis):
    axes = [a for a in range(loss.dim()) if a != batch_axis]
    return loss.mean(dim=axes) if axes else loss


def _softrelu(x):
    return _ops.activation(x, act_type="softrelu")


class Loss(HybridBlock):
    """Base of the losses: scalar ``weight`` and ``batch_axis``.  A loss
    holds no parameters and runs where its inputs lie, so it takes no
    device."""

    def __init__(self, weight, batch_axis):
        nn.Module.__init__(self)
        self.device = None
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (type(self).__name__,
                                            self._batch_axis, self._weight)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax and cross-entropy in one (reference: loss.py
    SoftmaxCrossEntropyLoss).

    ``sparse_label``: labels are class indices (any numeric dtype,
    truncated and clipped into range as
    :func:`~mxnet_tpu_torch.ops.matrix.pick` does), else distributions of
    ``pred``'s shape.  ``from_logits``:
    ``pred`` is already a log-softmax."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -_matrix.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2`` (reference: loss.py L2Loss)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class L1Loss(Loss):
    """``|pred - label|`` (reference: loss.py L1Loss)."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (of ``pred`` itself with
    ``from_sigmoid``), in the stable form ``relu(x) - x * z +
    softrelu(-|x|)``; ``pos_weight`` weighs the positive term (reference:
    loss.py SigmoidBinaryCrossEntropyLoss)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label \
                    + _softrelu(-torch.abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu(-torch.abs(pred)) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``, ``pred`` a log-softmax
    (``from_logits``) or logits (reference: loss.py KLDivLoss)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification loss (reference: loss.py
    CTCLoss; :func:`~mxnet_tpu_torch.ops.nn.ctc_loss` with the blank the
    last class, labels 0-based and padded with -1).  ``layout``: the
    predictions' ``"NTC"`` or ``"TNC"``; ``label_layout``: ``"NT"`` or
    ``"TN"``, whose batch axis is the loss's.  ``pred_lengths`` and
    ``label_lengths`` give each sample's lengths."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        if layout not in ("NTC", "TNC") or label_layout not in ("NT", "TN"):
            raise ValueError("CTCLoss: layout %r / label_layout %r"
                             % (layout, label_layout))
        super().__init__(weight, label_layout.find("N"))
        self._layout = layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = _ops.ctc_loss(pred, label, pred_lengths, label_lengths,
                             use_data_lengths=pred_lengths is not None,
                             use_label_lengths=label_lengths is not None,
                             blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|d| - rho / 2`` where ``|d| > rho``, else ``d^2 / (2 rho)``, ``d
    = pred - label`` (reference: loss.py HuberLoss)."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class HingeLoss(Loss):
    """``relu(margin - pred * label)``, labels -1 or 1 (reference: loss.py
    HingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2`` (reference: loss.py
    SquaredHingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * label.reshape(pred.shape)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class LogisticLoss(Loss):
    """Logistic loss of ``pred`` against labels -1/1 (``"signed"``) or
    0/1 (``"binary"``) (reference: loss.py LogisticLoss)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format must be signed or binary")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu(-torch.abs(pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class TripletLoss(Loss):
    """``relu(sum (pred - positive)^2 - (pred - negative)^2 + margin)``
    over every axis but the first (reference: loss.py TripletLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        loss = (torch.square(pred - positive)
                - torch.square(pred - negative)).sum(
                    dim=tuple(range(1, pred.dim())))
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``relu(cos - margin)`` otherwise, the
    cosine of the two inputs flattened per sample (reference: loss.py
    CosineEmbeddingLoss)."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input1.shape[0], -1)
        input2 = input2.reshape(input2.shape[0], -1)
        cos = (input1 * input2).sum(dim=1) / (
            torch.linalg.vector_norm(input1, dim=1)
            * torch.linalg.vector_norm(input2, dim=1) + 1e-12)
        label = label.reshape(-1)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)
