"""Symbolic checkpoints and the legacy FeedForward of the PyTorch port.

Counterpart of ``mxnet_tpu/model.py`` (reference: python/mxnet/model.py):

- ``save_checkpoint`` and ``load_checkpoint``: ``prefix-symbol.json``
  (the symbol's JSON) and ``prefix-%04d.params`` (an ``nd.save`` dict of
  ``arg:<name>`` and ``aux:<name>`` arrays, the JAX package's npz
  container), so a checkpoint written by either package loads in the
  other.  Each file is written to a temporary name and renamed, so a name
  only ever holds a whole file.  The JAX package's sidecar checksum
  manifest is neither written nor read.
- ``BatchEndParam``, what a batch-end callback gets (``epoch``,
  ``nbatch``, ``eval_metric``, ``locals``); the JAX package sets
  ``model.BatchEndParam`` to None (``model.py:16``) and keeps its class in
  ``module.base_module``.
- ``FeedForward`` (JAX ``model.py:37-208``): the estimator-style trainer
  over a :class:`~mxnet_tpu_torch.module.Module`, with ``fit``,
  ``predict``, ``score``, ``save``, ``load`` and ``create``, on numpy
  arrays, NDArrays or a DataIter.  Its device is ``gpu(0)`` unless
  ``ctx`` says otherwise (the JAX package's is ``cpu()``).
"""

from __future__ import annotations

import os

import numpy as np

from . import ndarray as _nd
from . import symbol as _sym

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam",
           "FeedForward"]


def _replace_into(path, write):
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (unless ``symbol`` is None) and
    ``prefix-%04d.params``."""
    del remove_amp_cast
    if symbol is not None:
        _replace_into("%s-symbol.json" % prefix, symbol.save)
    save = {"arg:%s" % k: v for k, v in arg_params.items()}
    save.update({"aux:%s" % k: v for k, v in aux_params.items()})
    _replace_into("%s-%04d.params" % (prefix, epoch),
                  lambda tmp: _nd.save(tmp, save))


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)``, the arrays on ``ctx``
    (``gpu(0)`` when None)."""
    symbol = _sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in _nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx).items():
        kind, name = k.split(":", 1)
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class BatchEndParam:
    """What a batch-end callback gets (reference: model.py
    BatchEndParam)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class FeedForward:
    """The legacy trainer (reference: model.py FeedForward, deprecated
    upstream for Module), over a Module on ``ctx`` (``gpu(0)`` when None).
    ``kwargs`` are the optimizer's parameters."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        import warnings

        from .initializer import Uniform

        warnings.warn("mxnet.model.FeedForward is deprecated; use "
                      "mxnet.mod.Module instead", DeprecationWarning,
                      stacklevel=2)
        del epoch_size
        self.symbol = symbol
        self.ctx = list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = dict(arg_params) if arg_params else None
        self.aux_params = dict(aux_params) if aux_params else None
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None
        self._signature = None

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        data = X.asnumpy() if isinstance(X, _nd.NDArray) else X
        label = y.asnumpy() if isinstance(y, _nd.NDArray) else y
        return NDArrayIter(data=data, label=label, shuffle=shuffle,
                           batch_size=min(self.numpy_batch_size, len(data)))

    def _bind(self, it, for_training):
        """The Module bound at ``it``'s shapes (rebound, keeping the
        learned parameters, when the shapes or the mode change)."""
        from .module import Module

        if self._module is None:
            self._module = Module(self.symbol, context=self.ctx[0])
        mod = self._module
        signature = (for_training, [tuple(d.shape) for d in it.provide_data])
        if self._signature != signature:
            if mod.binded and mod.params_initialized:
                self.arg_params, self.aux_params = mod.get_params()
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label if for_training else None,
                     for_training=for_training, force_rebind=True)
            self._signature = signature
            if self.allow_extra_params and self.arg_params:
                names = set(self.symbol.list_arguments())
                self.arg_params = {k: v for k, v in self.arg_params.items()
                                   if k in names}
            mod.init_params(initializer=self.initializer,
                            arg_params=self.arg_params,
                            aux_params=self.aux_params,
                            allow_missing=self.arg_params is not None)
        return mod

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train ``num_epoch`` epochs through ``Module.fit``."""
        del logger, work_load_list
        if self.num_epoch is None:
            raise ValueError("FeedForward.fit: num_epoch was not set")
        train = self._as_iter(X, y, shuffle=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod = self._bind(train, for_training=True)
        mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs),
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor, eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The first output of every sample (numpy; the padding of a
        last short batch dropped)."""
        it = self._as_iter(X)
        if reset:
            it.reset()
        mod = self._bind(it, for_training=False)
        outs, datas, labels = [], [], []
        for i, batch in enumerate(it):
            if num_batch is not None and i >= num_batch:
                break
            mod.forward(batch, is_train=False)
            n = batch.data[0].shape[0] - (batch.pad or 0)
            outs.append(mod.get_outputs()[0].asnumpy()[:n])
            if return_data:
                datas.append(batch.data[0].asnumpy()[:n])
                if batch.label:
                    labels.append(batch.label[0].asnumpy()[:n])
        out = np.concatenate(outs) if outs else np.empty((0,))
        if return_data:
            return (out, np.concatenate(datas),
                    np.concatenate(labels) if labels else None)
        return out

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """``eval_metric``'s value over ``X``."""
        from . import metric

        it = self._as_iter(X)
        if reset:
            it.reset()
        mod = self._bind(it, for_training=False)
        m = metric.create(eval_metric)
        mod.score(it, m, num_batch=num_batch,
                  batch_end_callback=batch_end_callback, reset=False)
        return m.get()[1]

    def save(self, prefix, epoch=None):
        """``save_checkpoint`` of the symbol and the learned parameters
        (at ``num_epoch`` unless ``epoch`` is given)."""
        epoch = self.num_epoch if epoch is None else epoch
        if self._module is not None and self._module.params_initialized:
            self.arg_params, self.aux_params = self._module.get_params()
        save_checkpoint(prefix, epoch or 0, self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward from a checkpoint (its parameters on the host
        until bound)."""
        from .context import cpu

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=cpu())
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """A new FeedForward, trained (reference: FeedForward.create)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
