"""Executor of the PyTorch port: runs a bound Symbol.

Counterpart of ``mxnet_tpu/executor.py`` (reference: src/executor/
graph_executor.cc).  The JAX executor evaluates the graph as one pure
function and jits it, forward and backward fused into one program that
runs at ``backward()`` (``executor.py:206-240``).  The port evaluates the
graph node by node with the registered ops.  ``forward(is_train=True)``
is lazy, and the graph runs once a batch whichever way the batch goes:

- ``forward`` then ``backward`` with no read between them (``fit``'s
  order): ``backward()`` runs the fused program: the forward,
  ``torch.autograd.grad`` of the outputs (the head gradients ones unless
  given; a loss head ignores its own) with respect to every argument
  whose ``grad_req`` is not ``"null"``, each gradient written
  (``"write"``) or added (``"add"``) into its array of ``grad_dict``, and
  the BatchNorm moving statistics (``momentum * old + (1 - momentum) *
  batch``) written into ``aux_dict``.
- ``forward``, a read of :attr:`Executor.outputs`, then ``backward`` (a
  manual loop's metric, a ``SequentialModule`` feeding the next module):
  the read runs the forward and keeps its activations, its moving
  statistics written once; ``backward`` takes the gradients from that
  same run (the same Dropout mask, the same batch statistics).  The JAX
  package gets the same masks by running the forward twice from one seed.

On the card each of the two is captured (:mod:`._capture`: an eager
warm-up whose effects on the gradient and auxiliary arrays are undone,
then the capture; later calls replay it).  The fused program is one CUDA
graph per bound executor and head-gradient signature (``graphs``).  The
read-then-backward pair is split as ``torch.cuda.make_graphed_callables``
splits a callable (``split_graphs``): a forward graph that keeps its
activations and, on its memory pool, one backward graph per
head-gradient signature over them.  Every array the graphs read or write
is the executor's own and is updated in place (``forward(data=...)``,
``copy_params_from``, an optimizer's update), so the graphs stay valid;
a capture that fails raises.  A graph that holds a ``Custom`` op (a host
callback into the user's Python, :mod:`.operator`) is not captured: its
executor runs eagerly on the card (``capture`` is False from the bind).
On the CPU every program runs eagerly.  :meth:`Executor._fused_eager` is
the fused program on any device, and ``capture = False`` makes the
executor run eagerly, so the two can be compared on the card.  A forward
in predict mode is captured too: one CUDA graph a bound executor
(``predict_graphs``, keyed as the fused program's graphs are), its
arguments its static inputs; :meth:`Executor._predict` is the eager
program.  ``forward_runs`` counts the graph's forward evaluations that
reached the caller (a warm-up or a capture is not one); ``route`` names
how the last train batch ran.

``set_monitor_callback(callback)`` calls ``callback(name, output)`` for
each output whenever the outputs are set (a predict forward, a read, a
``backward``); the outputs handed out are copies, never a graph's own
buffers.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from . import _capture
from . import autograd as _autograd
from .base import MXNetError
from .context import as_torch_device
from .ndarray import NDArray
from .ops import registry as _reg
from .ops.registry import OP_AUX_INPUTS, OP_INPUT_NAMES
from .symbol.symbol import op_attrs

__all__ = ["Executor", "eval_graph"]


class _FusedGraph:
    """The fused program captured at one head-gradient signature:
    ``heads`` are its static head-gradient inputs (None where ones are
    used), ``outs`` its static outputs."""

    def __init__(self, ex, heads):
        self.heads = [None if h is None else h.clone() for h in heads]

        def run():
            return ex._fused_eager(self.heads)

        _capture.warm_up(run, ex._state(), ex._device)
        self.graph, self.outs = _capture.capture(run, ex._device)
        self.replays = 0

    def run(self, heads):
        _copy_heads(self.heads, heads)
        self.graph.replay()
        self.replays += 1
        return [o.clone() for o in self.outs]


class _PredictGraph:
    """The predict-mode forward captured: it reads the executor's own
    arguments and auxiliary states and writes nothing, so its warm-up has
    no state to put back."""

    def __init__(self, ex):
        _capture.warm_up(ex._predict, [], ex._device)
        self.graph, self.outs = _capture.capture(ex._predict, ex._device)
        self.replays = 0

    def run(self):
        self.graph.replay()
        self.replays += 1
        return [o.clone() for o in self.outs]


class _SplitGraphs:
    """The read-then-backward pair captured (the split of
    ``torch.cuda.make_graphed_callables``): ``fwd``, the train forward
    that writes the moving statistics and keeps its activations and
    autograd graph, and in ``bwd``, one graph per head-gradient signature
    on ``fwd``'s memory pool, each the gradients over those activations
    written into ``grad_dict``.  A backward graph is captured at its
    signature's first backward; the autograd graph is kept for the next
    signature's capture."""

    def __init__(self, ex):
        self._ex = ex

        def run():
            ex._write_grads(*ex._train_forward(), [None] * ex._n_out)

        _capture.warm_up(run, ex._state(), ex._device)
        self.fwd, (self.outs, self.leaves) = _capture.capture(
            ex._train_forward, ex._device)
        self.bwd = {}
        self.replays = self.bwd_replays = 0

    def forward(self):
        self.fwd.replay()
        self.replays += 1
        return [o.detach().clone() for o in self.outs]

    def backward(self, heads):
        key = _heads_key(heads)
        entry = self.bwd.get(key)
        if entry is None:
            static = [None if h is None else h.clone() for h in heads]
            graph, _ = _capture.capture(
                lambda: self._ex._write_grads(self.outs, self.leaves, static,
                                              retain=True),
                self._ex._device, pool=self.fwd.pool())
            entry = self.bwd[key] = (graph, static)
        graph, static = entry
        _copy_heads(static, heads)
        graph.replay()
        self.bwd_replays += 1


def _copy_heads(static, heads):
    for s, h in zip(static, heads):
        if s is not None:
            s.copy_(h)


def _heads_key(heads):
    return tuple(None if h is None else (tuple(h.shape), h.dtype)
                 for h in heads)


def graph_capturable(symbol):
    """Whether ``symbol``'s graph can be captured: a ``Custom`` op calls
    back into the user's Python on the host, which a CUDA graph cannot
    hold."""
    return not any(n.op == "Custom" for n in symbol._topo_nodes()
                   if not n.is_variable)


class _PendingOutputs(Sequence):
    """What ``forward(is_train=True)`` returns: the executor's outputs,
    read at the first access (which runs the forward and keeps it for
    ``backward``)."""

    def __init__(self, ex):
        self._ex = ex

    def __getitem__(self, index):
        return self._ex.outputs[index]

    def __len__(self):
        return self._ex._n_out


class Executor:
    """A symbol bound to arrays on one device (reference: executor.py
    Executor): ``arg_dict``, ``grad_dict``, ``aux_dict``,
    ``output_dict``, ``forward``, ``backward``, ``outputs``."""

    def __init__(self, symbol, device, arg_arrays, grad_dict, grad_req,
                 aux_arrays):
        self._symbol = symbol
        self._device = as_torch_device(device)
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
        self._n_out = len(symbol._outputs)
        # a creation op with no input (a cell's zero begin state) makes
        # its array on the executor's device
        self._attrs = {id(n): op_attrs(n, self._device)
                       for n in self._nodes if not n.is_variable}
        self.capture = self._device.type == "cuda" and \
            graph_capturable(symbol)
        self.graphs = {}  # head-gradient signature -> _FusedGraph
        self.predict_graphs = {}  # the arrays' addresses -> _PredictGraph
        self.split_graphs = {}  # the arrays' addresses -> _SplitGraphs
        self.forward_runs = 0
        self.route = None
        self._outputs = None
        self._train_pending = False  # a forward(is_train=True) not yet run
        self._kept = None  # the read train forward, kept for backward
        self._monitor = None

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

    def debug_str(self):
        """The bound graph as text: its outputs, then each node in
        topological order (the JAX package's ``executor.py:377``)."""
        lines = ["Symbol outputs: %s"
                 % ", ".join(self._symbol.list_outputs())]
        for node in self._nodes:
            lines.append("Variable:%s" % node.name if node.is_variable
                         else "Op:%s, Name=%s" % (node.op, node.name))
        return "\n".join(lines)

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, output)`` for each output whenever the
        outputs are set (reference: MXExecutorSetMonitorCallback; the JAX
        package's ``executor.py:374``).  ``monitor_all`` (the inputs too)
        is accepted and, as in the JAX package, changes nothing."""
        del monitor_all
        self._monitor = callback

    # ------------------------------------------------------------ the graph
    def _eval(self, args, aux, is_train):
        """``(outputs, new aux)`` of the graph on tensors ``args`` and
        ``aux`` (in argument and aux order)."""
        outs, new_aux = eval_graph(
            self._symbol, self._nodes, self._aux_ids, self._attrs,
            dict(zip(self._arg_names, args)),
            dict(zip(self._aux_names, aux)), is_train)
        return outs, [new_aux[n] for n in self._aux_names]

    def _state(self):
        """The tensors a training run writes: the auxiliary states and
        the gradients (a warm-up puts them back)."""
        return [a._t for a in self.aux_arrays] + \
            [g._t for g in self.grad_dict.values()]

    def _predict(self):
        with torch.no_grad(), _autograd.predict_mode():
            outs, _ = self._eval([a._t for a in self.arg_arrays],
                                 [a._t for a in self.aux_arrays], False)
        return outs

    def _train_forward(self):
        """The train-mode forward with a graph for the gradients: the new
        auxiliary states written into ``aux_dict``; returns ``(outputs,
        leaves)``, the leaves the differentiable arguments."""
        args = [a._t for a in self.arg_arrays]
        leaves = [args[i].detach().requires_grad_() for i in self._diff]
        for i, leaf in zip(self._diff, leaves):
            args[i] = leaf
        with torch.enable_grad(), _autograd.train_mode():
            outs, new_aux = self._eval(args, [a._t for a in self.aux_arrays],
                                       True)
        with torch.no_grad():
            for a, v in zip(self.aux_arrays, new_aux):
                a._t.copy_(v.detach())
        return outs, leaves

    def _write_grads(self, outs, leaves, heads, retain=False):
        """``torch.autograd.grad`` of ``outs`` (head gradients ``heads``,
        ones where None) with respect to ``leaves``, written into
        ``grad_dict`` by ``grad_req``."""
        pairs = [(o, torch.ones_like(o) if h is None else h)
                 for o, h in zip(outs, heads) if o.requires_grad]
        grads = [None] * len(leaves)
        if pairs and leaves:
            grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                        [h for _, h in pairs],
                                        retain_graph=retain,
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

    def _fused_eager(self, heads):
        """The fused program, eagerly: the train-mode forward, the new
        auxiliary states into ``aux_dict``, the gradients into
        ``grad_dict`` by ``grad_req``; returns the outputs."""
        outs, leaves = self._train_forward()
        self._write_grads(outs, leaves, heads)
        return [o.detach() for o in outs]

    def _graph_key(self, heads):
        ptrs = tuple(t._t.data_ptr() for t in self.arg_arrays
                     + self.aux_arrays + list(self.grad_dict.values()))
        return ptrs + _heads_key(heads)

    # ------------------------------------------------------------ running
    def forward(self, is_train=False, **kwargs):
        """Copy ``kwargs`` (arrays by argument name) into the bound
        arguments; in predict mode run the graph now, in train mode leave
        it to the first read of :attr:`outputs` or to :meth:`backward`."""
        for name, arr in kwargs.items():
            dst = self.arg_dict.get(name)
            if dst is None:
                raise MXNetError("unknown argument %r" % name)
            dst[:] = arr
        self._outputs = None
        self._kept = None
        self._train_pending = bool(is_train)
        if not is_train:
            self._set_outputs(self._run(
                "forward", self._captured_predict if self.capture
                else self._predict))
            return self.outputs
        return _PendingOutputs(self)

    def _captured_predict(self):
        key = self._graph_key([])
        graph = self.predict_graphs.get(key)
        if graph is None:
            graph = self.predict_graphs[key] = _PredictGraph(self)
        return graph.run()

    def _run(self, what, fn, *args):
        """``fn(*args)``, one evaluation of the graph; a failure of the
        graph's ops raises :class:`MXNetError`."""
        try:
            out = fn(*args)
        except (TypeError, ValueError, RuntimeError, IndexError) as e:
            if isinstance(e, MXNetError):
                raise
            raise MXNetError("executor %s: %s" % (what, e)) from e
        self.forward_runs += 1
        return out

    def _set_outputs(self, outs):
        self._outputs = [NDArray(o) for o in outs]
        if self._monitor is not None:
            for name, out in zip(self._symbol.list_outputs(), self._outputs):
                self._monitor(name, out)

    def _read_train(self):
        """The read of a pending train forward: run it and keep it."""
        if self.capture:
            key = self._graph_key([])
            graphs = self.split_graphs.get(key)
            if graphs is None:
                graphs = self.split_graphs[key] = _SplitGraphs(self)
            self._kept = graphs
            return graphs.forward()
        outs, leaves = self._train_forward()
        self._kept = (outs, leaves)
        return [o.detach() for o in outs]

    @property
    def outputs(self):
        if self._outputs is None and self._train_pending:
            self._set_outputs(self._run("forward", self._read_train))
        return self._outputs if self._outputs is not None else []

    def backward(self, out_grads=None, is_train=True):
        """The gradients of the pending train forward (reference:
        MXExecutorBackwardEx): from the kept forward where its outputs
        were read, else by the fused program; captured on the card,
        eager on the CPU or with ``capture`` off."""
        del is_train
        if not self._train_pending:
            raise MXNetError("backward requires forward(is_train=True)")
        if out_grads is None:
            heads = [None] * self._n_out
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = [None if g is None else
                     (g._t if isinstance(g, NDArray) else torch.as_tensor(g))
                     .to(self._device) for g in out_grads]
        kept, outs = self._kept, None
        try:
            if isinstance(kept, _SplitGraphs):
                kept.backward(heads)
                self.route = "split graphs"
            elif kept is not None:
                self._write_grads(*kept, heads)
                self.route = "eager, forward kept"
            elif self.capture:
                key = self._graph_key(heads)
                graph = self.graphs.get(key)
                if graph is None:
                    graph = self.graphs[key] = _FusedGraph(self, heads)
                outs = self._run("backward", graph.run, heads)
                self.route = "fused graph"
            else:
                outs = self._run("backward", self._fused_eager, heads)
                self.route = "eager, fused"
        except (TypeError, ValueError, RuntimeError, IndexError) as e:
            if isinstance(e, MXNetError):
                raise
            raise MXNetError("executor backward: %s" % e) from e
        self._kept = None
        self._train_pending = False
        if self._outputs is None:
            self._set_outputs(outs)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor at new input shapes (reference: executor.py
        reshape); the arrays, gradients and auxiliary states whose shape
        stays are shared with this one."""
        from .ndarray import zeros

        del partial_shaping, allow_up_sizing
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        dev = self._device

        def same(a, s):
            return a is not None and a.shape == tuple(s)

        args = [a if same(a, s) else zeros(s, ctx=dev, dtype=a.dtype)
                for a, s in zip(self.arg_arrays, arg_shapes)]
        grads = {n: self.grad_dict[n] if same(self.grad_dict.get(n), s)
                 else zeros(s, ctx=dev)
                 for n, s in zip(self._arg_names, arg_shapes)
                 if self.grad_req.get(n, "write") != "null"}
        aux = [a if same(a, s) else zeros(s, ctx=dev)
               for a, s in zip(self.aux_arrays, aux_shapes)]
        return Executor(self._symbol, dev, args, grads, self.grad_req, aux)


def eval_graph(symbol, nodes, aux_ids, attrs, arg_map, aux_map, is_train):
    """``(outputs, new aux by name)`` of ``symbol``'s graph, node by node
    with the registered ops, on the tensors ``arg_map`` and ``aux_map``
    (name -> tensor); ``nodes`` are its topological order, ``aux_ids``
    its auxiliary nodes' ids and ``attrs`` each op node's attributes
    (:func:`~mxnet_tpu_torch.symbol.symbol.op_attrs`)."""
    new_aux = dict(aux_map)
    values = {}
    for node in nodes:
        if node.is_variable:
            values[id(node)] = (aux_map[node.name] if id(node) in aux_ids
                                else arg_map[node.name],)
            continue
        ins = [values[id(inp)][idx] for inp, idx in node.inputs]
        if node.op == "BatchNorm":
            out = _eval_batchnorm(node, ins, is_train, new_aux)
        else:
            out = _reg.get(node.op).fn(*ins, **attrs[id(node)])
        values[id(node)] = out if isinstance(out, tuple) else (out,)
    return [values[id(n)][idx] for n, idx in symbol._outputs], new_aux


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
