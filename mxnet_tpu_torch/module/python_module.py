"""PythonModule and PythonLossModule of the PyTorch port: modules written
in Python, with no Symbol.

Counterpart of ``mxnet_tpu/module/python_module.py:17-152`` (reference:
python/mxnet/module/python_module.py:28,243).  A :class:`PythonModule`
has no parameters unless a subclass gives it some; a subclass computes
its output shapes from the bound data shapes.  A
:class:`PythonLossModule` is the tail of a ``SequentialModule``: its
forward passes the scores through, and its backward hands back
``grad_func(scores, labels)``, the loss gradient computed in Python (an
NDArray, or an array that is put on the scores' device).
"""

from __future__ import annotations

import logging

import numpy as np

from ..ndarray import NDArray, array
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A module whose computation is written in Python."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # ------------------------------------------------------------ props
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # ------------------------------------------------------------ params
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        """No parameters: nothing to update (reference:
        python_module.py:134)."""

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------ binding
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert grad_req == "write", "PythonModule takes grad_req 'write'"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [(d[0], tuple(d[1])) for d in data_shapes]
        self._label_shapes = None if label_shapes is None else \
            [(l[0], tuple(l[1])) for l in label_shapes]
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """No parameters: no optimizer."""
        self.optimizer_initialized = True


class PythonLossModule(PythonModule):
    """A loss written in Python: the forward passes the scores on, the
    backward gives ``grad_func(scores, labels)`` as their gradient
    (reference: python_module.py:243)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        assert len(data_names) == 1 and len(label_names) == 1
        if grad_func is not None:
            assert callable(grad_func)
        self._name = name
        self._grad_func = grad_func
        self._scores = None
        self._labels = None
        self._scores_grad = None

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "a loss module takes no out_grads"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError()
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, NDArray):
            grad = array(np.asarray(grad), ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
