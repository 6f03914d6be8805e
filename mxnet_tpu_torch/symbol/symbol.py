"""Symbol of the PyTorch port: the declarative graph of MXNet's symbolic API.

Counterpart of ``mxnet_tpu/symbol/symbol.py`` (reference:
python/mxnet/symbol/symbol.py).  A Symbol is a list of outputs of a DAG
of op nodes; a node holds a registered op's name, its canonical
attributes, its inputs and the user's string attributes.  Node names,
argument order and the nnvm-style JSON (``{nodes, arg_nodes, heads}``)
are the JAX package's, so a symbol file of either package loads in the
other.

Shape inference solves the parameters' shapes from the data's by each
op's rules (FullyConnected, Convolution, BatchNorm, LayerNorm, Embedding,
RNN's packed parameters and states, prelu LeakyReLU and the loss heads'
labels), as the JAX package's ``_solve_params`` does, and takes each op's
output shape from running it on ``torch.device("meta")`` tensors, which
hold no memory.  Dimensions of 0 (unknown) in a variable's ``__shape__``,
such as the batch of a recurrent cell's ``begin_state`` variables, are
first solved by the JAX package's unification pass
(:func:`_propagate_partial`, forward and backward through element-wise
ops, shape-preserving unaries, FullyConnected, Convolution, SliceChannel
and Concat); a variable it leaves partial stays unknown.

``bind``/``simple_bind`` make an :class:`~mxnet_tpu_torch.executor.Executor`
on ``gpu(0)`` unless a device is given.
"""

from __future__ import annotations

import inspect
import json

import numpy as np
import torch

from ..attribute import AttrScope
from ..base import MXNetError
from ..name import NameManager
from ..ops import custom as _custom
from ..ops import registry as _reg
from ..ops.registry import OP_AUX_INPUTS, OP_INPUT_NAMES, OP_LABEL_INPUTS

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "attr_dict")

    def __init__(self, op, name, attrs, inputs, num_outputs=1,
                 attr_dict=None):
        self.op = op  # None for a variable
        self.name = name
        self.attrs = attrs  # the op's canonical attributes
        self.inputs = inputs  # [(node, output index)]
        self.num_outputs = num_outputs
        self.attr_dict = attr_dict or {}  # user attributes (lr_mult, ...)

    @property
    def is_variable(self):
        return self.op is None


class Symbol:
    """The outputs ``[(node, index)]`` of a graph."""

    def __init__(self, outputs):
        self._outputs = outputs

    # ---------------------------------------------------------- topology
    def _topo_nodes(self):
        """Every node once, inputs before their users (an iterative
        post-order walk, so deep graphs do not reach the recursion
        limit)."""
        seen, order = set(), []
        stack = [(node, False) for node, _ in reversed(self._outputs)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            stack.extend((inp, False) for inp, _ in reversed(node.inputs))
        return order

    def _aux_nodes(self):
        """The ids of the variables that feed an auxiliary-state input."""
        ids = set()
        for node in self._topo_nodes():
            aux = OP_AUX_INPUTS.get(node.op, ())
            for (inp, _), iname in zip(node.inputs,
                                       OP_INPUT_NAMES.get(node.op, ())):
                if iname in aux and inp.is_variable:
                    ids.add(id(inp))
        return ids

    def list_arguments(self):
        aux = self._aux_nodes()
        return [n.name for n in self._topo_nodes()
                if n.is_variable and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_nodes()
        return [n.name for n in self._topo_nodes() if id(n) in aux]

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.num_outputs > 1:
                names.append("%s_output%d" % (node.name, idx))
            else:
                names.append(node.name if node.is_variable
                             else node.name + "_output")
        return names

    def list_inputs(self):
        return [n.name for n in self._topo_nodes() if n.is_variable]

    @property
    def name(self):
        return self._outputs[0][0].name if len(self._outputs) == 1 else None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group [%s]" % ", ".join(
            n.name for n, _ in self._outputs))

    def __iter__(self):
        return (Symbol([out]) for out in self._outputs)

    def __bool__(self):
        raise MXNetError("Symbol has no truth value")

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            index = self.list_outputs().index(index)
        return Symbol([self._outputs[index]])

    def __copy__(self):
        return Symbol(list(self._outputs))

    def get_internals(self):
        """Every output of every node, as one grouped symbol."""
        return Symbol([(node, i) for node in self._topo_nodes()
                       for i in range(node.num_outputs)])

    def get_children(self):
        if len(self._outputs) != 1 or not self._outputs[0][0].inputs:
            return None
        return Symbol(list(self._outputs[0][0].inputs))

    # ---------------------------------------------------------- attrs
    def attr(self, key):
        if len(self._outputs) == 1:
            return self._outputs[0][0].attr_dict.get(key)
        return None

    def list_attr(self):
        if len(self._outputs) == 1:
            return dict(self._outputs[0][0].attr_dict)
        return {}

    def _set_attr(self, **kwargs):
        for node, _ in self._outputs:
            node.attr_dict.update({k: str(v) for k, v in kwargs.items()})

    def attr_dict(self):
        """``{node name: {attribute: string}}``, the op attributes and the
        user's, for every node that has any."""
        ret = {}
        for node in self._topo_nodes():
            d = dict(node.attr_dict)
            if node.op is not None:
                d.update({k: str(v) for k, v in node.attrs.items()})
            if d:
                ret[node.name] = d
        return ret

    # ---------------------------------------------------------- arithmetic
    def _binop(self, other, opname, scalarname, reverse=False):
        if isinstance(other, Symbol):
            return _create(opname, [other, self] if reverse
                           else [self, other], {})
        if isinstance(other, (int, float)):
            name = scalarname
            if reverse and "_r" + scalarname[1:] in _REV_SCALARS:
                name = "_r" + scalarname[1:]
            return _create(name, [self], {"scalar": float(other)})
        raise TypeError("unsupported operand: %r" % (other,))

    def __add__(self, o):
        return self._binop(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "elemwise_power", "_power_scalar")

    def __neg__(self):
        return _create("negative", [self], {})

    def __eq__(self, o):
        return self._binop(o, "elemwise_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binop(o, "elemwise_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "elemwise_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "elemwise_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "elemwise_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "elemwise_lesser_equal",
                           "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # the JAX Symbol's fluent methods, each the op it builds
    def reshape(self, shape, **kw):
        return _create("Reshape", [self], {"shape": shape, **kw})

    def sum(self, axis=None, keepdims=False):
        return _create("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _create("mean", [self], {"axis": axis, "keepdims": keepdims})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _create("transpose", [self], {"axes": axes})

    def softmax(self, axis=-1):
        return _create("softmax", [self], {"axis": axis})

    def slice_axis(self, axis, begin, end):
        return _create("slice_axis", [self], {"axis": axis, "begin": begin,
                                              "end": end})

    def astype(self, dtype):
        return _create("Cast", [self], {"dtype": str(np.dtype(dtype))})

    # ---------------------------------------------------------- inference
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes given
        (by position in :meth:`list_arguments` or by name).  Raises when
        an argument stays unknown or a given shape contradicts an op."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None for what stays unknown."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {n: tuple(s) for n, s in zip(arg_names, args)
                 if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, outs = _infer_shapes(self, known)
        arg_shapes = [shapes.get(n) for n in arg_names]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        if not partial:
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            if missing or any(s is None for s in aux_shapes):
                raise MXNetError("infer_shape: cannot infer %s" % missing)
        if any(s is None for s in outs):
            outs = None
        return arg_shapes, outs, aux_shapes

    def infer_type(self, *args, **kwargs):
        """Every argument, output and auxiliary state in the first type
        given (float32 by default), as the JAX package infers; an output
        of a ``Custom`` op in its prop's ``infer_type``."""
        dtype = np.dtype(args[0]) if args and args[0] is not None \
            else np.dtype(np.float32)

        def out_type(node, idx):
            if node.op != "Custom":
                return dtype
            _, types, _ = _custom.prop_for(
                node.attrs["op_type"],
                {k: v for k, v in node.attrs.items() if k != "op_type"}
            ).infer_type([dtype] * len(node.inputs))
            return np.dtype(types[idx])

        return ([dtype] * len(self.list_arguments()),
                [out_type(n, i) for n, i in self._outputs],
                [dtype] * len(self.list_auxiliary_states()))

    # ---------------------------------------------------------- binding
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """An executor with zero arrays of the shapes inferred from
        ``kwargs`` (``data=(batch, ...)``), on ``ctx`` (``gpu(0)`` when
        None), with gradient arrays for every argument whose ``grad_req``
        is not ``"null"``."""
        from ..context import resolve_device
        from ..executor import Executor
        from ..ndarray import zeros

        del stype_dict, group2ctx, shared_arg_names, shared_exec, \
            shared_buffer
        dev = resolve_device(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        type_dict = type_dict or {}
        args = [zeros(s, ctx=dev, dtype=type_dict.get(n, "float32"))
                for n, s in zip(arg_names, arg_shapes)]
        aux = [zeros(s, ctx=dev) for s in aux_shapes]
        reqs = _grad_reqs(grad_req, arg_names)
        grads = {n: zeros(s, ctx=dev) for n, s in zip(arg_names, arg_shapes)
                 if reqs.get(n, "write") != "null"}
        return Executor(self, dev, args, grads, reqs, aux)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An executor over the given arrays (a list in
        :meth:`list_arguments` order or a dict), moved to ``ctx`` where
        they lie elsewhere."""
        from ..context import resolve_device
        from ..executor import Executor

        del group2ctx, shared_exec
        dev = resolve_device(ctx)
        arg_names = self.list_arguments()
        if isinstance(args, dict):
            args = [args[n] for n in arg_names]
        if isinstance(args_grad, (list, tuple)):
            grads = dict(zip(arg_names, args_grad))
        else:
            grads = dict(args_grad or {})
        aux_states = aux_states if aux_states is not None else []
        if isinstance(aux_states, dict):
            aux_states = [aux_states[n] for n in self.list_auxiliary_states()]
        return Executor(self, dev, [a.as_in_context(dev) for a in args],
                        {n: g.as_in_context(dev) for n, g in grads.items()
                         if g is not None},
                        _grad_reqs(grad_req, arg_names),
                        [a.as_in_context(dev) for a in aux_states])

    def eval(self, ctx=None, **kwargs):
        """The outputs for the named arrays, in predict mode."""
        return self.bind(ctx, kwargs, grad_req="null").forward()

    # ---------------------------------------------------------- serialization
    def tojson(self):
        """nnvm-style JSON, as the JAX package writes it."""
        nodes = self._topo_nodes()
        ids = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": n.op or "null",
            "name": n.name,
            "attrs": {k: v if isinstance(v, str) else json.dumps(v)
                      for k, v in (n.attrs or {}).items()},
            "inputs": [[ids[id(inp)], idx, 0] for inp, idx in n.inputs],
        } for n in nodes]
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[ids[id(n)], idx, 0] for n, idx in self._outputs],
            "attrs": {"mxnet_version": ["int", 10500],
                      "mxnet_tpu": ["int", 1]}}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __call__(self, *args, **kwargs):
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        """Replace variables by other symbols (positionally in variable
        order, or by name), copying the nodes above them so that a shared
        upstream graph is left as it was."""
        name_map = {}
        if args:
            variables = [n for n in self._topo_nodes() if n.is_variable]
            name_map.update((v.name, a) for v, a in zip(variables, args))
        name_map.update(kwargs)
        replaced, copies = {}, {}

        def entry(inp, idx):
            if id(inp) in replaced:
                return replaced[id(inp)]
            if id(inp) in copies:
                return copies[id(inp)], idx
            return inp, idx

        for node in self._topo_nodes():
            if node.is_variable:
                if node.name in name_map:
                    replaced[id(node)] = name_map[node.name]._outputs[0]
                continue
            copies[id(node)] = _Node(node.op, node.name, node.attrs,
                                     [entry(i, x) for i, x in node.inputs],
                                     node.num_outputs, dict(node.attr_dict))
        self._outputs = [entry(n, idx) for n, idx in self._outputs]


_REV_SCALARS = {"_rminus_scalar", "_rdiv_scalar", "_rmod_scalar",
                "_rpower_scalar"}


def _grad_reqs(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return dict(grad_req)


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """A variable node (reference: symbol.var); ``shape``, ``lr_mult``,
    ``wd_mult``, ``dtype`` and ``init`` become its ``__<key>__``
    attributes."""
    del stype
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = AttrScope.current().get(attr)
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attr["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attr["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        attr["__dtype__"] = str(np.dtype(dtype))
    if init is not None:
        attr["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            attr[k] = str(v)
    return Symbol([(_Node(None, name, {}, [], 1, attr), 0)])


var = Variable


def Group(symbols):
    """One symbol with the outputs of all of ``symbols``."""
    return Symbol([out for s in symbols for out in s._outputs])


def _default_no_bias(op):
    p = inspect.signature(op.fn).parameters.get("no_bias")
    return bool(p.default) if p is not None \
        and p.default is not inspect.Parameter.empty else False


def _create(op_name, input_syms, attrs, name=None):
    """An op node over ``input_syms``; each missing named input becomes a
    ``<name>_<input>`` variable (no bias under ``no_bias``; prelu alone
    takes a ``gamma``)."""
    op = _reg.get(op_name)
    attrs = op.canonicalize_attrs({k: v for k, v in attrs.items()
                                   if v is not None})
    name = NameManager.current().get(name, op.name.lower().lstrip("_"))
    attr_dict = AttrScope.current().get({})
    slots = OP_INPUT_NAMES.get(op.name, ())
    no_bias = attrs.get("no_bias", _default_no_bias(op))
    inputs = []
    for pos, s in enumerate(input_syms):
        if isinstance(s, Symbol):
            if len(s._outputs) != 1:
                raise MXNetError("cannot use a grouped symbol as one input")
            inputs.append(s._outputs[0])
        elif s is None:
            slot = slots[pos] if pos < len(slots) else None
            if slot is None:
                raise TypeError("%s: input %d is None" % (op.name, pos))
            if slot == "bias" and no_bias:
                continue
            inputs.append(Variable("%s_%s" % (name, slot))._outputs[0])
        else:
            raise TypeError("symbol inputs must be Symbols")
    for slot in slots[len(inputs):]:
        if slot == "bias" and no_bias:
            continue
        if slot == "gamma" and op.name == "LeakyReLU" \
                and attrs.get("act_type", "leaky") != "prelu":
            continue
        inputs.append(Variable("%s_%s" % (name, slot))._outputs[0])
    if op.name == "Custom":
        # a custom op's arguments are its prop's; each one not given
        # becomes "<name>_<argument>" (mx.sym.Custom(data=x,
        # name="softmax") grows "softmax_label"), as in the JAX package
        # (symbol/symbol.py:559-566)
        for arg in _custom.input_names(attrs)[len(inputs):]:
            inputs.append(Variable("%s_%s" % (name, arg))._outputs[0])
    nout = op.nout(attrs)
    node = _Node(op.name, name, attrs, inputs, nout, attr_dict)
    return Symbol([(node, i) for i in range(nout)])


def _parse_attr_value(v):
    """An attribute of a symbol file: JSON first, then MXNet's strings
    (``"True"``, ``"(2, 2)"``, numbers); other strings stay strings."""
    if not isinstance(v, str):
        return v
    try:
        return json.loads(v)
    except (ValueError, TypeError):
        pass
    return _reg.canonical_attr(v)


def load_json(json_str):
    """A symbol from nnvm-style JSON (the JAX package's, or MXNet's)."""
    g = json.loads(json_str)
    nodes = []
    for jn in g["nodes"]:
        attrs = jn.get("attrs", jn.get("param", {})) or {}
        op = jn["op"] if jn["op"] != "null" else None
        inputs = [(nodes[i], idx) for i, idx, *_ in jn.get("inputs", [])]
        if op is None:
            nodes.append(_Node(None, jn["name"], {}, inputs, 1,
                               dict(attrs)))
            continue
        reg = _reg.get(op)
        parsed = reg.canonicalize_attrs(
            {k: _parse_attr_value(v) for k, v in attrs.items()})
        nodes.append(_Node(op, jn["name"], parsed, inputs,
                           reg.nout(parsed)))
    return Symbol([(nodes[i], idx) for i, idx, *_ in g["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------- shapes


def _infer_shapes(symbol, known):
    """``({variable: shape}, [output shape or None])``: the variables'
    shapes solved in one topological pass (the parameters' from each op's
    rules, :func:`_solve_params`), each node's outputs from a run on meta
    tensors."""
    shapes = dict(known)
    if _has_partial(symbol, shapes):
        # 0-marked dimensions are unified first; only the variables it
        # completes feed the main pass
        shapes = {k: v for k, v in shapes.items() if 0 not in v}
        shapes.update(_propagate_partial(symbol, known))
    outs = {}

    def entry_shape(inp, idx):
        if inp.is_variable:
            return shapes.get(inp.name)
        got = outs.get(id(inp))
        return got[idx] if got is not None else None

    for node in symbol._topo_nodes():
        if node.is_variable:
            s = node.attr_dict.get("__shape__")
            if node.name not in shapes and s is not None:
                s = tuple(int(d) for d in _parse_attr_value(s))
                if all(d > 0 for d in s):
                    shapes[node.name] = s
            continue
        in_shapes = [entry_shape(i, x) for i, x in node.inputs]
        if node.op == "Custom":
            outs[id(node)] = _custom_shapes(node, in_shapes, shapes)
            continue
        if in_shapes and in_shapes[0] is not None:
            _solve_params(node, in_shapes[0], shapes)
            in_shapes = [entry_shape(i, x) for i, x in node.inputs]
        outs[id(node)] = _meta_shapes(node, in_shapes)
    return shapes, [entry_shape(n, idx) for n, idx in symbol._outputs]


def _custom_shapes(node, in_shapes, shapes):
    """A ``Custom`` node's output shapes by its prop's ``infer_shape``
    (user code: it cannot run on meta tensors), and the shapes the prop
    gives its unknown variable inputs (a label's from the data's), as the
    JAX package's rule does (``symbol/symbol.py:1046-1070``): with every
    input known the prop's errors propagate, else they leave the node
    unknown."""
    if not in_shapes or in_shapes[0] is None:
        return None
    try:
        args, outs, _, _, _ = _custom.infer(node.attrs, in_shapes)
    except Exception:  # noqa: BLE001 - the user's code, on partial shapes
        if any(s is None for s in in_shapes):
            return None
        raise
    for (inp, _), s in zip(node.inputs, args):
        if s is not None and inp.is_variable and inp.name not in shapes:
            shapes[inp.name] = s
    return outs


def _meta_shapes(node, in_shapes):
    """The output shapes of ``node`` run on meta tensors of ``in_shapes``
    (predict mode), or None when an input is unknown or the op fails."""
    from .. import autograd

    if any(s is None for s in in_shapes):
        return None
    ins = [torch.empty(s, device="meta") for s in in_shapes]
    try:
        with torch.no_grad(), autograd.predict_mode():
            out = _reg.get(node.op).fn(*ins, **op_attrs(node, "meta"))
    except (RuntimeError, ValueError, TypeError, IndexError,
            NotImplementedError, MXNetError):
        return None
    return [tuple(o.shape) for o in (out if isinstance(out, (tuple, list))
                                     else (out,))]


def takes_device(node):
    """Whether ``node`` is a creation op with no input (``_zeros``, a
    cell's batch-1 begin state): its array is made on a device that the
    caller gives as its ``ctx``."""
    if node.is_variable or node.inputs:
        return False
    return "ctx" in inspect.signature(_reg.get(node.op).fn).parameters


def op_attrs(node, device):
    """``node``'s attributes, with ``ctx=device`` for a creation op that
    was given none."""
    if node.attrs.get("ctx") is None and takes_device(node):
        return dict(node.attrs, ctx=device)
    return node.attrs


def _has_partial(symbol, known):
    """Whether a shape given, or a variable's ``__shape__``, holds a 0."""
    if any(0 in tuple(v) for v in known.values()):
        return True
    for node in symbol._topo_nodes():
        if node.is_variable and node.name not in known \
                and "__shape__" in node.attr_dict:
            if 0 in tuple(_parse_attr_value(node.attr_dict["__shape__"])):
                return True
    return False


# ops whose first input and output share a shape exactly, and the
# element-wise ops whose operands and result do (for the unification
# pass; broadcast variants are not invertible)
_UNIFY_UNARY = {"relu", "sigmoid", "tanh", "softsign", "Activation",
                "softmax", "log_softmax", "BatchNorm", "LeakyReLU",
                "Dropout", "identity", "negative", "LayerNorm"}
_UNIFY_ELEMWISE = {"elemwise_add", "elemwise_sub", "elemwise_mul",
                   "elemwise_div"}


def _propagate_partial(symbol, known):
    """``{variable: complete shape}`` for every variable that a fixpoint
    over partial shapes (None for a 0 dimension) completes, forward and
    backward: element-wise ops and shape-preserving unaries unify their
    operands, FullyConnected and Convolution (stride 1 backward) carry
    the batch, SliceChannel and Concat their axes
    (``mxnet_tpu/symbol/symbol.py:680-949``; reference:
    src/executor/infer_graph_attr_pass.cc)."""
    nodes = symbol._topo_nodes()
    var_shapes, out_shapes = {}, {}

    def vec_of(shape):
        return [None if int(d) == 0 else int(d) for d in shape]

    for node in nodes:
        if node.is_variable:
            if node.name in known:
                var_shapes[node.name] = vec_of(known[node.name])
            elif "__shape__" in node.attr_dict:
                var_shapes[node.name] = vec_of(
                    _parse_attr_value(node.attr_dict["__shape__"]))
    state = {"changed": False}

    def get(inp, idx):
        if inp.is_variable:
            return var_shapes.get(inp.name)
        return out_shapes.get((id(inp), idx))

    def unify(a, b, what):
        if a is None:
            return list(b) if b is not None else None
        if b is None:
            return list(a)
        if len(a) != len(b):
            raise MXNetError("infer_shape: rank mismatch at %s: %r vs %r"
                             % (what, a, b))
        out = []
        for x, y in zip(a, b):
            if x is not None and y is not None and x != y:
                raise MXNetError("infer_shape: dim mismatch at %s: %r vs %r"
                                 % (what, a, b))
            out.append(x if x is not None else y)
        return out

    def merge(store, key, vec, what):
        merged = unify(store.get(key), vec, what)
        if merged != store.get(key):
            store[key] = merged
            state["changed"] = True

    def put(inp, idx, vec, what):
        if vec is None:
            return
        if inp.is_variable:
            merge(var_shapes, inp.name, vec, what)
        else:
            merge(out_shapes, (id(inp), idx), vec, what)

    def put_out(node, idx, vec):
        if vec is not None:
            merge(out_shapes, (id(node), idx), vec, node.name)

    def ival(attrs, key, default=None):
        v = attrs.get(key, default)
        return _parse_attr_value(v) if isinstance(v, str) else v

    def elemwise(node, ins, me):
        # operands and result share a shape; where a known 1 meets a
        # larger dimension the node broadcasts: leave it alone
        vecs = [v for v in [me] + [get(i, x) for i, x in ins]
                if v is not None]
        if any(len(a) == len(b) and any(
                x is not None and y is not None and x != y and 1 in (x, y)
                for x, y in zip(a, b))
               for i, a in enumerate(vecs) for b in vecs[i + 1:]):
            return
        merged = me
        for inp, idx in ins:
            merged = unify(merged, get(inp, idx), node.name)
        for inp, idx in ins:
            put(inp, idx, merged, node.name)
        put_out(node, 0, merged)

    def flatten_rule(node, ins, me):
        data = get(*ins[0])
        batch = data[0] if data is not None else None
        if batch is None and me is not None:
            batch = me[0]
        tail = None
        if data is not None and all(d is not None for d in data[1:]):
            tail = int(np.prod(data[1:]))
        put_out(node, 0, [batch, tail])
        if data is not None:
            put(ins[0][0], ins[0][1], [batch] + data[1:], node.name)

    def fc_rule(node, ins, me):
        nh = ival(node.attrs, "num_hidden")
        if nh is None:
            return
        nh, flat = int(nh), bool(ival(node.attrs, "flatten", True))
        data = get(*ins[0])
        batch = data[0] if data is not None else None
        if me is not None and batch is None:
            batch = me[0]
        if flat:
            put_out(node, 0, [batch, nh])
        elif data is not None:
            put_out(node, 0, [batch] + data[1:-1] + [nh])
        elif me is not None:
            put_out(node, 0, [batch] + me[1:-1] + [nh])
        if data is None:
            return
        lead = [batch] + data[1:]
        if not flat and me is not None and len(me) == len(data):
            lead = [batch] + [d if d is not None else o for d, o in
                              zip(data[1:-1], me[1:-1])] + [data[-1]]
        put(ins[0][0], ins[0][1], lead, node.name)
        rest = data[1:] if flat else data[-1:]
        if all(d is not None for d in rest) and len(ins) > 1:
            put(ins[1][0], ins[1][1], [nh, int(np.prod(rest))], node.name)

    def conv_rule(node, ins, me):
        a = node.attrs
        k, nf = tuple(ival(a, "kernel", ())), ival(a, "num_filter")
        if len(k) != 2 or nf is None:
            return
        s = tuple(ival(a, "stride", (1, 1)) or (1, 1))
        p = tuple(ival(a, "pad", (0, 0)) or (0, 0))
        dl = tuple(ival(a, "dilate", (1, 1)) or (1, 1))
        data = get(*ins[0])
        if (data is not None and len(data) != 4) or \
                (me is not None and len(me) != 4):
            raise MXNetError("infer_shape: Convolution at %s expects "
                             "rank-4 NCHW shapes" % node.name)
        batch = data[0] if data is not None else None
        if batch is None and me is not None:
            batch = me[0]
        fwd, back = [batch, int(nf), None, None], [None, None]
        for i in range(2):
            eff = dl[i] * (k[i] - 1)
            if data is not None and data[2 + i] is not None:
                fwd[2 + i] = (data[2 + i] + 2 * p[i] - eff - 1) // s[i] + 1
            if me is not None and me[2 + i] is not None and s[i] == 1:
                back[i] = me[2 + i] - 2 * p[i] + eff  # exactly invertible
        put_out(node, 0, fwd)
        if data is not None:
            put(ins[0][0], ins[0][1],
                [batch, data[1], back[0] if data[2] is None else data[2],
                 back[1] if data[3] is None else data[3]], node.name)

    def split_rule(node, ins, me):
        n = ival(node.attrs, "num_outputs")
        if n is None:
            return
        n, ax = int(n), int(ival(node.attrs, "axis", 1))
        squeeze = bool(ival(node.attrs, "squeeze_axis", False))
        data = get(*ins[0])
        for i in range(node.num_outputs):
            out_i = out_shapes.get((id(node), i))
            if data is not None:
                a = ax % len(data)
                if squeeze:
                    vec = data[:a] + data[a + 1:]
                else:
                    vec = list(data)
                    vec[a] = None if data[a] is None else data[a] // n
                put_out(node, i, vec)
            if out_i is not None:
                if squeeze:
                    a = ax % (len(out_i) + 1)
                    back = out_i[:a] + [n] + out_i[a:]
                else:
                    a = ax % len(out_i)
                    back = list(out_i)
                    back[a] = None if out_i[a] is None else out_i[a] * n
                put(ins[0][0], ins[0][1], back, node.name)

    def concat_rule(node, ins, me):
        vecs = [get(inp, idx) for inp, idx in ins]
        rank = next((len(v) for v in vecs if v is not None),
                    len(me) if me is not None else None)
        if rank is None:
            return
        d = int(ival(node.attrs, "dim", 1)) % rank
        proto = [None] * rank  # the axes other than d, across everything
        for v in vecs + [me]:
            if v is None:
                continue
            if len(v) != rank:
                raise MXNetError("infer_shape: concat rank mismatch at %s"
                                 % node.name)
            for i in range(rank):
                if i != d and v[i] is not None:
                    if proto[i] is not None and proto[i] != v[i]:
                        raise MXNetError("infer_shape: concat dim mismatch "
                                         "at %s" % node.name)
                    proto[i] = v[i]
        for (inp, idx), v in zip(ins, vecs):
            vec = list(proto)
            vec[d] = v[d] if v is not None else None
            put(inp, idx, vec, node.name)
        dims = [v[d] if v is not None else None for v in vecs]
        out_d = sum(dims) if all(x is not None for x in dims) else None
        if out_d is None and me is not None and me[d] is not None \
                and sum(x is None for x in dims) == 1:
            i = dims.index(None)
            vec = list(proto)
            vec[d] = me[d] - sum(x for x in dims if x is not None)
            put(ins[i][0], ins[i][1], vec, node.name)
            out_d = me[d]
        outv = list(proto)
        outv[d] = out_d
        put_out(node, 0, outv)

    def step(node):
        ins, me = node.inputs, out_shapes.get((id(node), 0))
        if node.op in _UNIFY_ELEMWISE:
            elemwise(node, ins, me)
        elif node.op in _UNIFY_UNARY and ins:
            merged = unify(me, get(*ins[0]), node.name)
            put(ins[0][0], ins[0][1], merged, node.name)
            put_out(node, 0, merged)
        elif node.op == "Flatten" and ins:
            flatten_rule(node, ins, me)
        elif node.op == "FullyConnected":
            fc_rule(node, ins, me)
        elif node.op == "Convolution" and \
                str(ival(node.attrs, "layout", "NCHW") or "NCHW") == "NCHW":
            conv_rule(node, ins, me)
        elif node.op == "SliceChannel":
            split_rule(node, ins, me)
        elif node.op == "Concat":
            concat_rule(node, ins, me)

    op_nodes = [n for n in nodes if not n.is_variable]
    for _ in range(100):
        state["changed"] = False
        # a forward and a reverse sweep an iteration, so that a deep
        # chain (an unrolled RNN) converges in a few iterations
        for node in op_nodes:
            step(node)
        for node in reversed(op_nodes):
            step(node)
        if not state["changed"]:
            break
    return {name: tuple(v) for name, v in var_shapes.items()
            if v is not None and all(d is not None for d in v)}


def _solve_params(node, data_shape, shapes):
    """Set the shapes of ``node``'s parameter variables from its data's
    (``mxnet_tpu/symbol/symbol.py:1044-1233``).  A given shape that
    contradicts an op's rule raises; a label's shape is a hint only."""
    names = OP_INPUT_NAMES.get(node.op, ())
    a = node.attrs

    def setv(slot, shape, strict=True):
        i = names.index(slot) if slot in names else len(node.inputs)
        if i >= len(node.inputs):
            return
        inp, _ = node.inputs[i]
        if not inp.is_variable:
            return
        want = tuple(int(x) for x in shape)
        have = shapes.get(inp.name)
        if have is None:
            shapes[inp.name] = want
        elif strict and tuple(have) != want:
            raise MXNetError(
                "infer_shape: inconsistent shape for %r: provided %r, op "
                "semantics of %r require %r" % (inp.name, tuple(have),
                                                node.name, want))

    if node.op == "FullyConnected":
        nh = int(a.get("num_hidden", 1))
        flat = a.get("flatten", True)
        in_dim = int(np.prod(data_shape[1:])) if flat else data_shape[-1]
        setv("weight", (nh, in_dim))
        setv("bias", (nh,))
    elif node.op == "Convolution":
        k = tuple(a.get("kernel", ()))
        nf = int(a.get("num_filter", 1))
        ng = int(a.get("num_group", 1))
        last = str(a.get("layout") or "NCHW").endswith("C")
        cin = data_shape[-1] if last else data_shape[1]
        setv("weight", ((nf,) + k + (cin // ng,)) if last
             else ((nf, cin // ng) + k))
        setv("bias", (nf,))
    elif node.op == "Deconvolution":
        # (in_c, out_c/groups, *kernel), channel-first data only
        k = tuple(a.get("kernel", ()))
        nf = int(a.get("num_filter", 1))
        ng = int(a.get("num_group", 1))
        setv("weight", (data_shape[1], nf // ng) + k)
        setv("bias", (nf,))
    elif node.op == "BatchNorm":
        c = data_shape[int(a.get("axis", 1)) % len(data_shape)]
        for slot in names[1:]:
            setv(slot, (c,))
    elif node.op == "LayerNorm":
        c = data_shape[int(a.get("axis", -1)) % len(data_shape)]
        setv("gamma", (c,))
        setv("beta", (c,))
    elif node.op == "Embedding":
        setv("weight", (int(a.get("input_dim", 1)),
                        int(a.get("output_dim", 1))))
    elif node.op == "RNN":
        # data (T, B, in) fixes the packed vector and the states
        # (reference: rnn-inl.h RNNShape)
        from ..ops.rnn import rnn_param_size

        h, layers = int(a.get("state_size", 0)), int(a.get("num_layers", 1))
        bidir = bool(a.get("bidirectional", False))
        _, b, din = data_shape
        setv("parameters", (rnn_param_size(layers, din, h, bidir,
                                           a.get("mode", "lstm")),))
        for slot in ("state", "state_cell"):
            setv(slot, (layers * (2 if bidir else 1), b, h))
    elif node.op == "LeakyReLU" and a.get("act_type") == "prelu":
        setv("gamma", (data_shape[1],))
    elif node.op in OP_LABEL_INPUTS:
        if node.op != "SoftmaxOutput":
            setv("label", data_shape, strict=False)
        elif a.get("multi_output"):
            setv("label", (data_shape[0],) + tuple(data_shape[2:]),
                 strict=False)
        else:
            setv("label", data_shape[:-1], strict=False)
