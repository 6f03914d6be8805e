"""Executor of the PyTorch port: runs a bound Symbol.

Counterpart of ``mxnet_tpu/executor.py`` (reference: src/executor/
graph_executor.cc).  The JAX executor evaluates the graph as one pure
function and jits it, forward and backward fused into one program that
runs at ``backward()`` (``executor.py:206-240``).  The port evaluates the
graph node by node with the registered ops; ``forward(is_train=True)`` is
lazy (its outputs are computed at their first read, or by ``backward``:
the JAX package's forward computes them at once, so a training batch
runs its forward twice there), and ``backward()`` runs the fused program:
the forward,
``torch.autograd.grad`` of the outputs (the head gradients ones unless
given; a loss head ignores its own) with respect to every argument whose
``grad_req`` is not ``"null"``, each gradient written (``"write"``) or
added (``"add"``) into its array of ``grad_dict``, and the BatchNorm
moving statistics (``momentum * old + (1 - momentum) * batch``) written
into ``aux_dict``.

On the card the fused program is one captured CUDA graph per bound
executor and head-gradient signature (:mod:`._capture`: an eager warm-up
whose effects on the gradient and auxiliary arrays are undone, then the
capture; later calls replay it).  Every array the graph reads or writes is
the executor's own and is updated in place (``forward(data=...)``,
``copy_params_from``, an optimizer's update), so the graph stays valid; a
capture that fails raises.  On the CPU the program runs eagerly.
:meth:`Executor._fused_eager` is that eager program on any device, and
``capture = False`` makes ``backward`` run it, so the two can be compared
on the card.  A forward in predict mode runs eagerly everywhere.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from . import _capture
from . import autograd as _autograd
from .base import MXNetError
from .ndarray import NDArray
from .ops import registry as _reg
from .ops.registry import OP_AUX_INPUTS, OP_INPUT_NAMES
from .symbol.symbol import op_attrs

__all__ = ["Executor"]


class _FusedGraph:
    """The fused program captured at one head-gradient signature:
    ``heads`` are its static head-gradient inputs (None where ones are
    used), ``outs`` its static outputs."""

    def __init__(self, ex, heads):
        self.heads = [None if h is None else h.clone() for h in heads]
        state = [a._t for a in ex.aux_arrays] + \
            [g._t for g in ex.grad_dict.values()]

        def run():
            return ex._fused_eager(self.heads)

        _capture.warm_up(run, state, ex._device)
        self.graph, self.outs = _capture.capture(run, ex._device)
        self.replays = 0

    def run(self, heads):
        for s, h in zip(self.heads, heads):
            if s is not None:
                s.copy_(h)
        self.graph.replay()
        self.replays += 1
        return [o.clone() for o in self.outs]


class _PendingOutputs(Sequence):
    """What ``forward(is_train=True)`` returns: the executor's outputs,
    read at the first access, so that a forward followed by ``backward``
    runs the graph once (in the fused program) rather than twice."""

    def __init__(self, ex):
        self._ex = ex

    def __getitem__(self, index):
        return self._ex.outputs[index]

    def __len__(self):
        return len(self._ex._symbol._outputs)


class Executor:
    """A symbol bound to arrays on one device (reference: executor.py
    Executor): ``arg_dict``, ``grad_dict``, ``aux_dict``,
    ``output_dict``, ``forward``, ``backward``, ``outputs``."""

    def __init__(self, symbol, device, arg_arrays, grad_dict, grad_req,
                 aux_arrays):
        self._symbol = symbol
        self._device = torch.device(device)
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.arg_arrays = list(arg_arrays)
        self.aux_arrays = list(aux_arrays)
        if len(self.arg_arrays) != len(self._arg_names) or \
                len(self.aux_arrays) != len(self._aux_names):
            raise MXNetError("bind: %d arguments and %d auxiliary states "
                             "given for %d and %d" % (
                                 len(self.arg_arrays), len(self.aux_arrays),
                                 len(self._arg_names), len(self._aux_names)))
        self.grad_req = dict(grad_req)
        self.grad_dict = {n: g for n, g in grad_dict.items()
                          if self.grad_req.get(n, "write") != "null"}
        self.grad_arrays = [self.grad_dict.get(n) for n in self._arg_names]
        self._diff = [i for i, n in enumerate(self._arg_names)
                      if n in self.grad_dict]
        self._nodes = symbol._topo_nodes()
        self._aux_ids = symbol._aux_nodes()
        # a creation op with no input (a cell's zero begin state) makes
        # its array on the executor's device
        self._attrs = {id(n): op_attrs(n, self._device)
                       for n in self._nodes if not n.is_variable}
        self.capture = self._device.type == "cuda"
        self.graphs = {}  # head-gradient signature -> _FusedGraph
        self._outputs = None
        self._train_pending = False  # a forward(is_train=True) not yet run
        self._aux_before = None  # aux as it was, once a train forward ran

    # ------------------------------------------------------------ dicts
    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy arrays into the bound ones, in place, by name."""
        for params, own, what in ((arg_params, self.arg_dict, "arguments"),
                                  (aux_params or {}, self.aux_dict,
                                   "aux states")):
            for name, array in params.items():
                if name in own:
                    array.copyto(own[name])
                elif not allow_extra_params:
                    raise MXNetError("Found name %r not in %s"
                                     % (name, what))

    # ------------------------------------------------------------ the graph
    def _eval(self, args, aux, is_train):
        """``(outputs, new aux)`` of the graph on tensors ``args`` and
        ``aux`` (in argument and aux order)."""
        arg_map = dict(zip(self._arg_names, args))
        aux_map = dict(zip(self._aux_names, aux))
        new_aux = dict(aux_map)
        values = {}
        for node in self._nodes:
            if node.is_variable:
                values[id(node)] = (aux_map[node.name]
                                    if id(node) in self._aux_ids
                                    else arg_map[node.name],)
                continue
            ins = [values[id(inp)][idx] for inp, idx in node.inputs]
            if node.op == "BatchNorm":
                out = _eval_batchnorm(node, ins, is_train, new_aux)
            else:
                out = _reg.get(node.op).fn(*ins, **self._attrs[id(node)])
            values[id(node)] = out if isinstance(out, tuple) else (out,)
        outs = [values[id(n)][idx] for n, idx in self._symbol._outputs]
        return outs, [new_aux[n] for n in self._aux_names]

    def _forward_only(self, is_train):
        mode = _autograd.train_mode() if is_train \
            else _autograd.predict_mode()
        try:
            with torch.no_grad(), mode:
                outs, new_aux = self._eval([a._t for a in self.arg_arrays],
                                           [a._t for a in self.aux_arrays],
                                           is_train)
                if is_train:
                    self._aux_before = [a._t.clone()
                                        for a in self.aux_arrays]
                    for a, v in zip(self.aux_arrays, new_aux):
                        a._t.copy_(v)
        except (TypeError, ValueError, RuntimeError, IndexError) as e:
            if isinstance(e, MXNetError):
                raise
            raise MXNetError("executor forward: %s" % e) from e
        return outs

    def _fused_eager(self, heads):
        """The fused program, eagerly: the train-mode forward, the
        gradients into ``grad_dict`` by ``grad_req``, the new auxiliary
        states into ``aux_dict``; returns the outputs."""
        args = [a._t for a in self.arg_arrays]
        leaves = [args[i].detach().requires_grad_() for i in self._diff]
        for i, leaf in zip(self._diff, leaves):
            args[i] = leaf
        with torch.enable_grad(), _autograd.train_mode():
            outs, new_aux = self._eval(args, [a._t for a in self.aux_arrays],
                                       True)
            pairs = [(o, torch.ones_like(o) if h is None else h)
                     for o, h in zip(outs, heads) if o.requires_grad]
            grads = [None] * len(leaves)
            if pairs and leaves:
                grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                            [h for _, h in pairs],
                                            allow_unused=True)
        with torch.no_grad():
            for i, g in zip(self._diff, grads):
                name = self._arg_names[i]
                buf = self.grad_dict[name]._t
                if self.grad_req.get(name, "write") == "add":
                    if g is not None:
                        buf.add_(g)
                elif g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
            for a, v in zip(self.aux_arrays, new_aux):
                a._t.copy_(v)
        return [o.detach() for o in outs]

    def _graph_key(self, heads):
        ptrs = tuple(t._t.data_ptr() for t in self.arg_arrays
                     + self.aux_arrays + list(self.grad_dict.values()))
        return ptrs + tuple(None if h is None else tuple(h.shape)
                            for h in heads)

    # ------------------------------------------------------------ running
    def forward(self, is_train=False, **kwargs):
        """Copy ``kwargs`` (arrays by argument name) into the bound
        arguments; in predict mode run the graph now, in train mode leave
        it to :meth:`backward` (or to the first read of
        :attr:`outputs`)."""
        for name, arr in kwargs.items():
            dst = self.arg_dict.get(name)
            if dst is None:
                raise MXNetError("unknown argument %r" % name)
            dst[:] = arr
        self._outputs = None
        self._aux_before = None
        self._train_pending = bool(is_train)
        if not is_train:
            self._set_outputs(self._forward_only(False))
            return self.outputs
        return _PendingOutputs(self)

    def _set_outputs(self, outs):
        self._outputs = [NDArray(o) for o in outs]

    @property
    def outputs(self):
        if self._outputs is None and self._train_pending:
            self._set_outputs(self._forward_only(True))
        return self._outputs if self._outputs is not None else []

    def backward(self, out_grads=None, is_train=True):
        """The fused forward and backward (reference: MXExecutorBackwardEx):
        captured on the card, eager on the CPU or with ``capture`` off."""
        del is_train
        if not self._train_pending:
            raise MXNetError("backward requires forward(is_train=True)")
        n = len(self._symbol._outputs)
        if out_grads is None:
            heads = [None] * n
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [None if g is None else
                     (g._t if isinstance(g, NDArray) else torch.as_tensor(g))
                     .to(self._device) for g in out_grads]
        if self._aux_before is not None:  # a train forward ran already
            with torch.no_grad():
                for a, v in zip(self.aux_arrays, self._aux_before):
                    a._t.copy_(v)
        try:
            if self.capture:
                key = self._graph_key(heads)
                graph = self.graphs.get(key)
                if graph is None:
                    graph = self.graphs[key] = _FusedGraph(self, heads)
                outs = graph.run(heads)
            else:
                outs = self._fused_eager(heads)
        except (TypeError, ValueError, RuntimeError, IndexError) as e:
            if isinstance(e, MXNetError):
                raise
            raise MXNetError("executor backward: %s" % e) from e
        self._aux_before = None
        self._train_pending = False
        if self._outputs is None:
            self._set_outputs(outs)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor at new input shapes; arrays whose shape stays
        are shared."""
        from .ndarray import zeros

        del partial_shaping, allow_up_sizing
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        dev = self._device
        args = [a if a.shape == tuple(s) else zeros(s, ctx=dev,
                                                    dtype=a.dtype)
                for a, s in zip(self.arg_arrays, arg_shapes)]
        grads = {n: zeros(s, ctx=dev)
                 for n, s in zip(self._arg_names, arg_shapes)
                 if self.grad_req.get(n, "write") != "null"}
        aux = [a if a.shape == tuple(s) else zeros(s, ctx=dev)
               for a, s in zip(self.aux_arrays, aux_shapes)]
        return Executor(self._symbol, dev, args, grads, self.grad_req, aux)


def _eval_batchnorm(node, ins, is_train, new_aux):
    """BatchNorm with the moving statistics' update returned in
    ``new_aux`` (``mxnet_tpu/executor.py:112-132``)."""
    attrs = dict(node.attrs)
    use_global = (not is_train) or attrs.get("use_global_stats", False)
    want_mv = attrs.get("output_mean_var", False)
    attrs.update(use_global_stats=use_global, output_mean_var=True)
    out, mean, var = _reg.get("BatchNorm").fn(*ins, **attrs)
    if not use_global:
        m = attrs.get("momentum", 0.9)
        for (inp, _), iname in zip(node.inputs, OP_INPUT_NAMES["BatchNorm"]):
            if inp.is_variable and iname in OP_AUX_INPUTS["BatchNorm"] \
                    and inp.name in new_aux:
                stat = mean if iname == "moving_mean" else var
                new_aux[inp.name] = m * new_aux[inp.name] + (1.0 - m) * stat
    return (out, mean, var) if want_mv else out
