"""Module of the PyTorch port: a symbol trained through its executor.

Counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py, bind:364, init_optimizer:474, update:644)
on one device.  The parameters' host copies (``get_params``) are NDArrays
on the CPU; the bound ones live on the Module's device, ``gpu(0)`` unless
``context`` says otherwise.  With one device a kvstore of ``"local"``,
``"device"`` or None means no store (``_create_kvstore``); a distributed
store or a store object raises.  ``update`` applies the optimizer to
every parameter with a gradient, one updater index a parameter, in
place; on the card the forward and backward before it are one captured
CUDA graph (:mod:`..executor`).

A Module bound with ``shared_module`` shares that module's parameter
storage and host copies, as MXNet's does (one bucket of a
``BucketingModule``): an update through either is seen by both, with no
copy.  ``borrow_optimizer`` shares the optimizer and its states, keyed
by parameter name, the lender's index for each name.  ``state_names``
are inputs that ``get_states``/``set_states`` read and write.
``reshape`` rebinds at new shapes over the same parameter, gradient and
optimizer storage; ``install_monitor`` watches the executor's outputs.
"""

from __future__ import annotations

import logging
import os

from .. import optimizer as opt
from ..base import MXNetError
from ..context import cpu
from ..initializer import InitDesc, Uniform
from ..model import load_checkpoint, save_checkpoint
from ..ndarray import zeros
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup, one_device

__all__ = ["Module"]


def _create_kvstore(kvstore):
    """With one device, no store: ``"local"``, ``"device"`` or None.
    A distributed store or a store object raises (``module.py:25-47``)."""
    if kvstore is None:
        return None
    if isinstance(kvstore, str) and "dist" not in kvstore:
        return None
    raise MXNetError("Module: kvstore %r is not ported; one device takes "
                     "'local', 'device' or None" % (kvstore,))


def _norm_shapes(shapes):
    return [(s.name, tuple(s.shape)) if hasattr(s, "name")
            else (s[0], tuple(s[1])) for s in shapes]


class Module(BaseModule):
    """A symbol with its data and label names, bound on one device."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        del work_load_list, group2ctxs, compression_params
        self._device = one_device(context)
        self._context = [self._device]
        self._symbol = symbol
        data_names = list(data_names or [])
        label_names = list(label_names or [])
        inputs = data_names + label_names + list(state_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._update_keys = None  # the updater's index a parameter

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint (either package's)."""
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=cpu())
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, *self.get_params())
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # ------------------------------------------------------------- props
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """``[(name, shape)]`` of the outputs at the bound shapes (by
        shape inference: no forward needs to have run)."""
        assert self.binded
        shapes = dict(self._data_shapes + (self._label_shapes or []))
        shapes.update(self._exec_group._state_shapes())
        _, outs, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, [tuple(s) for s in outs]))

    # ------------------------------------------------------------- params
    def get_params(self):
        assert self.binded or self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill the host copies, by name from ``arg_params``/``aux_params``
        or by ``initializer`` (sorted by name), and copy them to the
        device."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and not (arg_params or aux_params):
            initializer = Uniform(0.01)
        ex = self._exec_group.execs[0]
        if self._arg_params is None:
            self._arg_params = {
                n: zeros(ex.arg_dict[n].shape, ctx=cpu(),
                         dtype=ex.arg_dict[n].dtype)
                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {
                n: zeros(ex.aux_dict[n].shape, ctx=cpu(),
                         dtype=ex.aux_dict[n].dtype)
                for n in self._aux_names}

        def fill(name, arr, given, desc):
            if given is not None and name in given:
                src = given[name]
                if src is not arr:
                    if src.shape != arr.shape:
                        raise MXNetError("shape mismatch for %s: %s vs %s"
                                         % (name, src.shape, arr.shape))
                    arr[:] = src
            elif initializer is not None:
                initializer(desc, arr)
            elif given is not None and not allow_missing:
                raise MXNetError("%s is not presented" % name)

        attrs = self._symbol.attr_dict()
        for params, given in ((self._arg_params, arg_params),
                              (self._aux_params, aux_params)):
            for name, arr in sorted(params.items()):
                fill(name, arr, given, InitDesc(name, attrs.get(name)))
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._arg_params = arg_params
        self._aux_params = aux_params
        self.params_initialized = True
        self._params_dirty = False

    # ------------------------------------------------------------- binding
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind an executor at these batch shapes on the Module's
        device."""
        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _norm_shapes(data_shapes)
        self._label_shapes = _norm_shapes(label_shapes) \
            if label_shapes else None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, None, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad,
            shared_group=(shared_module._exec_group
                          if shared_module is not None else None),
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names)
        self.binded = True
        if shared_module is not None:
            ex, src = self._exec_group.execs[0], \
                shared_module._exec_group.execs[0]
            unshared = [n for n in self._param_names
                        if ex.arg_dict[n] is not src.arg_dict.get(n)] + \
                [n for n in self._aux_names
                 if ex.aux_dict[n] is not src.aux_dict.get(n)]
            if unshared:
                raise MXNetError(
                    "bind: %s not in the shared module at the same shape; "
                    "a module bound with shared_module shares every "
                    "parameter" % ", ".join(unshared))
            if shared_module.params_initialized:
                self._share_params(shared_module)
        elif self.params_initialized:
            # set before bind (Module.load): copy to the device
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _share_params(self, shared_module):
        """Take ``shared_module``'s host copies (its parameter storage is
        this module's since bind)."""
        self._arg_params = shared_module._arg_params
        self._aux_params = shared_module._aux_params
        self.params_initialized = True

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the optimizer (by name, with ``rescale_grad`` 1/batch,
        ``sym`` and ``param_idx2name`` given, so the symbol's multipliers
        and the no-decay rule apply) and its updater."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        _create_kvstore(kvstore)
        rescale_grad = 1.0 / self._exec_group.batch_size
        idx2name = dict(enumerate(self._exec_group.param_names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size "
                    "(%s vs. %s).", optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Update through ``shared_module``'s optimizer and its states."""
        assert shared_module.optimizer_initialized
        keys = shared_module._update_keys or \
            range(len(shared_module._param_names))
        index = dict(zip(shared_module._param_names, keys))
        missing = [n for n in self._param_names if n not in index]
        if missing:
            raise MXNetError("borrow_optimizer: %s not among the lender's "
                             "parameters" % ", ".join(missing))
        self._update_keys = [index[n] for n in self._param_names]
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # ------------------------------------------------------------- running
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step of every parameter with a gradient, in
        place (reference: module.py update:644)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        group = self._exec_group
        keys = self._update_keys or range(len(group.param_names))
        for key, weights, grads in zip(keys, group.param_arrays,
                                       group.grad_arrays):
            if grads:
                self._updater(key, grads[0].data_torch,
                              weights[0].data_torch)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def get_states(self, merge_multi_context=True):
        """The arrays of the state inputs (``state_names``)."""
        assert self.binded and self.params_initialized
        return self._exec_group.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        """Write the state inputs: from ``states`` or every element
        ``value``."""
        assert self.binded and self.params_initialized
        self._exec_group.set_states(states=states, value=value)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        """Watch the executor's outputs with ``mon`` (reference: MXNet's
        Module.install_monitor, ``mon.install(executor)`` through
        ``set_monitor_callback``), and the executor of each later
        ``reshape``.  The JAX package's Module hands the executor to a
        Monitor that takes Gluon blocks only, and raises."""
        assert self.binded
        self._exec_group.install_monitor(mon)

    def reshape(self, data_shapes, label_shapes=None):
        """Bind at new data (and label) shapes, keeping the parameters,
        their gradients and the optimizer's states: the new executor
        shares every array whose shape stays (reference: module.py
        reshape over ``Executor.reshape``).  The executor of each shape
        is kept, so a return to an earlier shape takes its executor back,
        captured graphs included."""
        assert self.binded
        self._data_shapes = _norm_shapes(data_shapes)
        self._label_shapes = _norm_shapes(label_shapes) \
            if label_shapes else None
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        """The updater's states, written to a temporary name and
        renamed."""
        assert self.optimizer_initialized
        tmp = "%s.%d.tmp" % (fname, os.getpid())
        with open(tmp, "wb") as f:
            f.write(self._updater.get_states())
        os.replace(tmp, fname)

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
