"""Gluon losses of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference:
python/mxnet/gluon/loss.py): ``Loss`` and ``SoftmaxCrossEntropyLoss``
(alias ``SoftmaxCELoss``).  A loss returns the per-sample loss: the mean
over every axis but ``batch_axis``.
"""

from __future__ import annotations

from torch import nn

from ..ops import matrix as _matrix
from ..ops import nn as _ops
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


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
