"""The executor group of the PyTorch port's Module, on one device.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (reference:
python/mxnet/module/executor_group.py:143).  The port binds one executor
on one device: a batch is not split, and a list of more than one context
raises :class:`~mxnet_tpu_torch.base.MXNetError` (multi-GPU training, the
kvstore over ``torch.distributed``, is not ported yet).  ``grad_req`` is
the parameters' (``"null"`` for the fixed ones and when not training),
``"null"`` for the labels and the states, and the data's only with
``inputs_need_grad``.  The state inputs (``state_names``, a recurrent
cell's ``begin_state`` variables) are bound at the batch size: each 0 of a
state's ``__shape__`` becomes the batch (its first dimension where it has
no 0); ``set_states`` writes them in place, so that a captured graph reads
the new values, as it reads the data.
"""

from __future__ import annotations

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["DataParallelExecutorGroup", "one_device"]


def one_device(contexts):
    """The one device of ``contexts`` (a device or a list of one);
    ``gpu(0)`` when None."""
    if isinstance(contexts, (list, tuple)):
        if len(contexts) != 1:
            raise MXNetError(
                "Module: %d contexts given; the port binds one device, and "
                "multi-GPU training (data parallel executors over a "
                "kvstore) is not ported yet" % len(contexts))
        contexts = contexts[0]
    return resolve_device(contexts)


class DataParallelExecutorGroup:
    """One executor for ``symbol`` at the batch shapes given."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None):
        del workload, logger
        self.symbol = symbol
        self.state_names = list(state_names or [])
        self.device = one_device(contexts)
        self.contexts = [self.device]
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.param_names = param_names
        self.fixed_param_names = set(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_names = [d[0] for d in data_shapes]
        self.label_names = [l[0] for l in label_shapes or []]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.batch_size = data_shapes[0][1][0]
        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = "null" if (
                    name in self.fixed_param_names or not for_training) \
                    else grad_req
            elif name in self.data_names and inputs_need_grad:
                self.grad_req[name] = grad_req
            else:
                self.grad_req[name] = "null"
        shapes = dict(data_shapes)
        shapes.update(label_shapes or [])
        shapes.update(self._state_shapes())
        ex = symbol.simple_bind(ctx=self.device, grad_req=self.grad_req,
                                **shapes)
        if shared_group is not None:
            # share the parameters' storage with the other group's
            # executor, so updates through either module reach both
            src_args, src_aux = shared_group.execs[0].arg_dict, \
                shared_group.execs[0].aux_dict
            for j, name in enumerate(ex._arg_names):
                if name in self.param_names and name in src_args and \
                        src_args[name].shape == ex.arg_arrays[j].shape:
                    ex.arg_arrays[j] = src_args[name]
            for j, name in enumerate(ex._aux_names):
                if name in src_aux and \
                        src_aux[name].shape == ex.aux_arrays[j].shape:
                    ex.aux_arrays[j] = src_aux[name]
        self.execs = [ex]
        self._monitor = None
        self._by_shape = {self._shape_key(): ex}

    def _shape_key(self):
        return (tuple(self.data_shapes), tuple(self.label_shapes or ()))

    def reshape(self, data_shapes, label_shapes=None):
        """Make the executor of these shapes the current one: the one
        kept from an earlier bind at them, else ``Executor.reshape`` of
        the current one (sharing every array whose shape stays)."""
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.batch_size = data_shapes[0][1][0]
        key = self._shape_key()
        ex = self._by_shape.get(key)
        if ex is None:
            shapes = dict(data_shapes)
            shapes.update(label_shapes or [])
            shapes.update(self._state_shapes())
            ex = self._by_shape[key] = self.execs[0].reshape(**shapes)
            if self._monitor is not None:
                self._monitor.install(ex)
        self.execs = [ex]

    def install_monitor(self, mon):
        """Install ``mon`` on the executor of every shape, now and at
        each later reshape."""
        self._monitor = mon
        for ex in self._by_shape.values():
            mon.install(ex)

    def _state_shapes(self):
        """The state inputs' shapes at this batch size, from their
        variables' ``__shape__``."""
        from ..symbol.symbol import _parse_attr_value

        shapes = {}
        for node in self.symbol._topo_nodes():
            if node.is_variable and node.name in self.state_names \
                    and "__shape__" in node.attr_dict:
                s = [int(d) for d in _parse_attr_value(
                    node.attr_dict["__shape__"])]
                if 0 not in s:
                    s[0] = 0
                shapes[node.name] = tuple(self.batch_size if d == 0 else d
                                          for d in s)
        return shapes

    def get_states(self, merge_multi_context=True):
        """The state inputs' arrays, in ``state_names`` order."""
        states = [self.execs[0].arg_dict[n] for n in self.state_names]
        return states if merge_multi_context else [[s] for s in states]

    def set_states(self, states=None, value=None):
        """Write the state inputs in place: from ``states`` (one array a
        state, or a list of one a device as ``get_states(False)`` gives)
        or every element ``value``."""
        if (states is None) == (value is None):
            raise ValueError("set_states: give exactly one of states and "
                             "value")
        ad = self.execs[0].arg_dict
        for i, name in enumerate(self.state_names):
            if value is not None:
                ad[name][:] = value
            else:
                src = states[i]
                ad[name][:] = src[0] if isinstance(src, (list, tuple)) \
                    else src

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters into the given dicts' arrays."""
        ex = self.execs[0]
        for name in self.param_names:
            arg_params[name][:] = ex.arg_dict[name]
        for name in self.aux_names:
            aux_params[name][:] = ex.aux_dict[name]

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self.data_names, data_batch.data))
        feed.update(zip(self.label_names, data_batch.label or []))
        self.execs[0].forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        self.execs[0].backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        grads = [self.execs[0].grad_dict.get(n) for n in self.data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    @property
    def grad_arrays(self):
        """``grad_arrays[param index]``: the list of its one device's
        gradient (empty for a fixed parameter)."""
        gd = self.execs[0].grad_dict
        return [[gd[n]] if n in gd else [] for n in self.param_names]

    @property
    def param_arrays(self):
        ad = self.execs[0].arg_dict
        return [[ad[n]] for n in self.param_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels[0] if pre_sliced else labels,
                           self.execs[0].outputs)
