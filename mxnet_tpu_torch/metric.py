"""Evaluation metrics of the PyTorch port.

Counterpart of ``mxnet_tpu/metric.py`` (reference: python/mxnet/metric.py):
``EvalMetric``, ``CompositeEvalMetric``, ``create``, ``Accuracy``,
``TopKAccuracy``, ``CrossEntropy``, ``NegativeLogLikelihood``,
``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``F1`` and ``MCC`` (binary,
``average="macro"`` over the updates or ``"micro"`` over the samples),
``PearsonCorrelation``, ``Loss`` with its ``Torch`` and ``Caffe`` aliases,
and ``CustomMetric`` with ``np``.  Metrics run on the host in numpy, from
NDArrays or numpy arrays, so their values equal the JAX package's on the
same inputs.  A composite's
``get`` takes its children's numpy scalars as MXNet's does (the JAX
package's takes Python numbers only, and raises on a numpy float32).
"""

from __future__ import annotations

import math

import numpy as _np

from .base import MXNetError

_REG = {}


def register(klass, name=None):
    """Register a metric class under its lower-cased name."""
    _REG[(name or klass.__name__).lower()] = klass
    return klass


def alias(*aliases):
    """Register a metric class under more names."""
    def deco(klass):
        for n in aliases:
            _REG[n.lower()] = klass
        return klass

    return deco


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    klass = _REG.get(str(metric).lower())
    if klass is None:
        raise MXNetError("metric %r is not registered; known: %s"
                         % (metric, sorted(_REG)))
    return klass(*args, **kwargs)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}".format(
                label_shape, pred_shape))
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


def _to_numpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else _np.asarray(x)


class EvalMetric:
    """Base metric (reference: metric.py EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, _np.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register
@alias("acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p = _to_numpy(pred)
            l = _to_numpy(label).astype("int32")
            if p.ndim > l.ndim:
                p = p.argmax(axis=self.axis)
            p = p.astype("int32").reshape(-1)
            l = l.reshape(-1)
            check_label_shapes(l, p)
            self.sum_metric += (p == l).sum()
            self.num_inst += len(p)


@register
@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "Use Accuracy for top_k=1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p = _np.argsort(_to_numpy(pred).astype("float32"), axis=-1)
            l = _to_numpy(label).astype("int32")
            num_samples = p.shape[0]
            num_dims = len(p.shape)
            if num_dims == 1:
                self.sum_metric += (p.reshape(-1) == l.reshape(-1)).sum()
            elif num_dims == 2:
                num_classes = p.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (p[:, num_classes - 1 - j].reshape(-1)
                                        == l.reshape(-1)).sum()
            self.num_inst += num_samples


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            l = _to_numpy(label)
            p = _to_numpy(pred)
            if len(l.shape) == 1:
                l = l.reshape(l.shape[0], 1)
            if len(p.shape) == 1:
                p = p.reshape(p.shape[0], 1)
            self.sum_metric += _np.abs(l - p).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            l = _to_numpy(label)
            p = _to_numpy(pred)
            if len(l.shape) == 1:
                l = l.reshape(l.shape[0], 1)
            if len(p.shape) == 1:
                p = p.reshape(p.shape[0], 1)
            self.sum_metric += ((l - p) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            l = _to_numpy(label)
            p = _to_numpy(pred)
            if len(l.shape) == 1:
                l = l.reshape(l.shape[0], 1)
            if len(p.shape) == 1:
                p = p.reshape(p.shape[0], 1)
            self.sum_metric += _np.sqrt(((l - p) ** 2.0).mean())
            self.num_inst += 1


@register
@alias("ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            l = _to_numpy(label).ravel()
            p = _to_numpy(pred)
            assert l.shape[0] == p.shape[0]
            prob = p[_np.arange(l.shape[0]), _np.int64(l)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += l.shape[0]


@register
@alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    update = CrossEntropy.update


class Perplexity(EvalMetric):
    """reference: metric.py Perplexity (exp of per-token CE)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            l = _to_numpy(label).astype("int64").ravel()
            p = _to_numpy(pred)
            p = p.reshape(-1, p.shape[-1])
            probs = p[_np.arange(l.shape[0]), l]
            if self.ignore_label is not None:
                ignore = (l == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _np.log(_np.maximum(1e-10, probs)).sum()
            num += l.shape[0]
        self.sum_metric += _np.exp(loss / num) if num > 0 else 0.0
        self.num_inst += 1


register(Perplexity, "perplexity")


@register
@alias("loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            loss = _to_numpy(pred).sum()
            self.sum_metric += loss
            self.num_inst += pred.size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class _BinaryClassificationMetrics:
    """The true and false positives and negatives of a binary
    classifier's argmax (JAX ``metric.py:205-263``)."""

    def __init__(self):
        self.reset_stats()

    def update_binary_stats(self, label, pred):
        pred_label = _np.argmax(pred, axis=1)
        label = label.astype("int32").reshape(-1)
        if len(_np.unique(label)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % type(self).__name__)
        self.true_positives += ((pred_label == 1) & (label == 1)).sum()
        self.false_positives += ((pred_label == 1) & (label == 0)).sum()
        self.false_negatives += ((pred_label == 0) & (label == 1)).sum()
        self.true_negatives += ((pred_label == 0) & (label == 0)).sum()

    @property
    def precision(self):
        tp_fp = self.true_positives + self.false_positives
        return self.true_positives / tp_fp if tp_fp > 0 else 0.0

    @property
    def recall(self):
        tp_fn = self.true_positives + self.false_negatives
        return self.true_positives / tp_fn if tp_fn > 0 else 0.0

    @property
    def fscore(self):
        pr = self.precision + self.recall
        return 2 * self.precision * self.recall / pr if pr > 0 else 0.0

    @property
    def matthewscc(self):
        terms = [self.true_positives + self.false_positives,
                 self.true_positives + self.false_negatives,
                 self.true_negatives + self.false_positives,
                 self.true_negatives + self.false_negatives]
        denom = 1.0
        for t in terms:
            denom *= t if t != 0 else 1.0
        return ((self.true_positives * self.true_negatives
                 - self.false_positives * self.false_negatives)
                / math.sqrt(denom))

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives
                + self.true_negatives + self.true_positives)

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0


@register
class F1(EvalMetric):
    """The F1 score of a binary classifier: ``average="macro"`` averages
    each update's score, ``"micro"`` scores all samples together."""

    _stat = "fscore"

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(_to_numpy(label),
                                             _to_numpy(pred))
        value = getattr(self.metrics, self._stat)
        if self.average == "macro":
            self.sum_metric += value
            self.num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = value * self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class MCC(F1):
    """The Matthews correlation coefficient of a binary classifier."""

    _stat = "matthewscc"

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names, average=average)


@register
@alias("pearson_correlation")
class PearsonCorrelation(EvalMetric):
    """Pearson's r of predictions and labels, averaged over updates."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.sum_metric += _np.corrcoef(_to_numpy(pred).ravel(),
                                            _to_numpy(label).ravel())[0, 1]
            self.num_inst += 1


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            l = _to_numpy(label)
            p = _to_numpy(pred)
            reval = self._feval(l, p)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a CustomMetric (reference: metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
