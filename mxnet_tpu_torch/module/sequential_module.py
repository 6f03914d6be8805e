"""SequentialModule of the PyTorch port: modules chained, each one's
outputs the next one's data.

Counterpart of ``mxnet_tpu/module/sequential_module.py`` (reference:
python/mxnet/module/sequential_module.py:28).  ``add(module,
take_labels=, auto_wiring=)`` appends a module: ``take_labels`` marks the
one that gets the labels (and updates the metric); ``auto_wiring``
(the default for every module after the first) names the previous
module's outputs by this module's data names.  The modules after the
first bind with ``inputs_need_grad=for_training``, so that ``backward``
hands each one's input gradients to the module before it as its
``out_grads``.

A module's outputs are read at its forward to feed the next module, so
each symbolic module runs the read-then-backward route of its executor
(:mod:`..executor`): its forward runs once a batch and its backward
takes the gradients from that run.
"""

from __future__ import annotations

import logging

from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """A chain of modules, run in order."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append ``module`` (``take_labels``, ``auto_wiring``); the
        chain must be bound again.  Returns self."""
        for key in kwargs:
            assert key in (self.META_TAKE_LABELS, self.META_AUTO_WIRING), \
                "unknown meta %r" % (key,)
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # ------------------------------------------------------------ props
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # ------------------------------------------------------------ params
    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        """Each module takes its own names from ``arg_params`` and
        ``aux_params`` (the rest by ``initializer``)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=True, force_init=force_init,
                               allow_extra=True)
        self.params_initialized = True

    # ------------------------------------------------------------ binding
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind each module at the shapes the one before it outputs."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert shared_module is None, \
            "shared_module is not supported for SequentialModule"
        assert self._modules, "add modules before binding"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        takes_labels = False
        for i, (meta, module) in enumerate(zip(self._metas, self._modules)):
            meta.setdefault(self.META_AUTO_WIRING, i > 0)
            my_label_shapes = None
            if meta.get(self.META_TAKE_LABELS):
                my_label_shapes = label_shapes
                takes_labels = True
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=(inputs_need_grad if i == 0
                                          else for_training),
                        force_rebind=force_rebind, grad_req=grad_req)
            if i + 1 == len(self._modules):
                break
            outs = list(module.output_shapes)
            if self._metas[i + 1].get(self.META_AUTO_WIRING, True):
                names = self._modules[i + 1].data_names
                assert len(names) == len(outs), (
                    "module %d outputs %d arrays but module %d takes %d"
                    % (i, len(outs), i + 1, len(names)))
                my_data_shapes = [(n, tuple(s)) for n, (_, s)
                                  in zip(names, outs)]
            else:
                my_data_shapes = [(n, tuple(s)) for n, s in outs]
        if not takes_labels:
            self._label_shapes = None
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # ------------------------------------------------------------ running
    def forward(self, data_batch, is_train=None):
        """Each module's forward on the previous module's outputs."""
        assert self.binded and self.params_initialized
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            out = module.get_outputs()
            names = self._modules[i + 1].data_names
            batch = DataBatch(
                data=out, label=data_batch.label,
                pad=getattr(data_batch, "pad", 0),
                provide_data=[(n, o.shape) for n, o in zip(names, out)],
                provide_label=getattr(data_batch, "provide_label", None))

    def backward(self, out_grads=None):
        """The last module's backward, then each one's with the input
        gradients of the module after it."""
        assert self.binded and self.params_initialized
        for i in range(len(self._modules) - 1, -1, -1):
            module = self._modules[i]
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """The metric of each module that takes the labels."""
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
