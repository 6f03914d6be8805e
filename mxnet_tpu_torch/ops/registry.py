"""Operator registry of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/registry.py`` (reference: nnvm's
``NNVM_REGISTER_OP`` and the per-op attribute tables).  An operator is a
plain function ``fn(*tensors, **attrs)`` on ``torch.Tensor``s that returns
a tensor or a tuple of them; PyTorch's autograd records it when grad mode
is on, so no gradient table is kept.  Names and aliases are the JAX
package's, letter for letter, so ``mx.nd.<op>`` is the same call in both.

The JAX registry's jit cache, cost capture and bucket hints are telemetry
of XLA dispatch; they have no counterpart here (eager PyTorch).
"""

from __future__ import annotations

import ast

import numpy as np

from ..base import MXNetError

__all__ = ["Op", "register", "get", "alias", "list_ops", "apply_op",
           "OP_INPUT_NAMES", "OP_AUX_INPUTS", "OP_LABEL_INPUTS",
           "canonical_attr"]

_OP_REGISTRY: dict = {}

# Ordered tensor-input names of the ported ops that take tensors by
# keyword (reference: each op's ListArguments()); nd.<op> pulls these
# keywords in as tensor inputs, in this order, after the positional ones,
# and a Symbol grows a "<name>_<input>" variable for each one not given.
OP_INPUT_NAMES = {
    "Convolution": ("data", "weight", "bias"),
    "Deconvolution": ("data", "weight", "bias"),
    "FullyConnected": ("data", "weight", "bias"),
    "BatchNorm": ("data", "gamma", "beta", "moving_mean", "moving_var"),
    "LayerNorm": ("data", "gamma", "beta"),
    "Embedding": ("data", "weight"),
    "LeakyReLU": ("data", "gamma"),
    "dot": ("lhs", "rhs"),
    "batch_dot": ("lhs", "rhs"),
    "where": ("condition", "x", "y"),
    "take": ("a", "indices"),
    "SoftmaxOutput": ("data", "label"),
    "LinearRegressionOutput": ("data", "label"),
    "MAERegressionOutput": ("data", "label"),
    "LogisticRegressionOutput": ("data", "label"),
    "RNN": ("data", "parameters", "state", "state_cell"),
    "CTCLoss": ("data", "label", "data_lengths", "label_lengths"),
}

# Inputs that are auxiliary states: no gradient, updated by the executor
# (reference: list_auxiliary_states).
OP_AUX_INPUTS = {"BatchNorm": ("moving_mean", "moving_var")}

# The loss heads, whose "label" input is a data input of the Module.
OP_LABEL_INPUTS = {"SoftmaxOutput", "LinearRegressionOutput",
                   "MAERegressionOutput", "LogisticRegressionOutput"}


def canonical_attr(v):
    """An attribute value in canonical form: MXNet's string attributes
    (``"(2,2)"``, ``"True"``, ``"0.5"``, ``"None"``) parsed, lists made
    tuples, numpy scalars made Python numbers.  Other strings (``"relu"``,
    ``"float32"``) stay as they are."""
    if isinstance(v, str):
        s = v.strip()
        low = s.lower()
        if low in ("true", "false"):
            return low == "true"
        try:
            parsed = ast.literal_eval(s)
        except (ValueError, SyntaxError):
            return v
        if parsed is None or isinstance(parsed, (bool, int, float, tuple,
                                                 list)):
            return canonical_attr(parsed)
        return v
    if isinstance(v, (list, tuple)):
        return tuple(canonical_attr(x) for x in v)
    if isinstance(v, np.ndarray) and v.ndim <= 1:
        return tuple(v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    return v


class Op:
    """A registered operator: ``name`` (canonical), ``fn``, ``num_outputs``
    (an int, or a callable of the attrs), ``aliases`` and ``defaults``."""

    def __init__(self, name, fn, num_outputs=1, aliases=(), defaults=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.aliases = tuple(aliases)
        self.defaults = dict(defaults or {})

    def __repr__(self):
        return "Op(%s)" % self.name

    def canonicalize_attrs(self, attrs):
        out = dict(self.defaults)
        out.update(attrs)
        return {k: canonical_attr(v) for k, v in out.items()}

    def nout(self, attrs):
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs


def register(name, num_outputs=1, aliases=(), **defaults):
    """Decorator: register ``fn(*tensors, **attrs)`` as operator ``name``
    (and under each alias)."""

    def deco(fn):
        op = Op(name, fn, num_outputs=num_outputs, aliases=aliases,
                defaults=defaults)
        for n in (name,) + op.aliases:
            prev = _OP_REGISTRY.get(n)
            if prev is not None and prev.fn is not fn:
                raise MXNetError(
                    "Operator name %r is already registered (to %r); use "
                    "alias() to share an implementation explicitly"
                    % (n, prev.name))
            _OP_REGISTRY[n] = op
        return fn

    return deco


def get(name):
    op = _OP_REGISTRY.get(name)
    if op is None:
        raise MXNetError("Operator %r is not registered" % (name,))
    return op


def alias(name, target):
    """Register ``name`` as another name of the registered op ``target``.
    Raises when ``target`` is unknown, ``name`` is bound to another op, or
    the two disagree on their tensor inputs in :data:`OP_INPUT_NAMES`."""
    op = _OP_REGISTRY.get(target)
    if op is None:
        raise MXNetError(
            "alias(%r, %r): target operator is not registered"
            % (name, target))
    prev = _OP_REGISTRY.get(name)
    if prev is not None:
        if prev is op:
            return
        raise MXNetError("alias(%r, %r): name is already registered (to %r)"
                         % (name, target, prev.name))
    n_in, t_in = OP_INPUT_NAMES.get(name), OP_INPUT_NAMES.get(op.name)
    if n_in is not None and t_in is not None and len(n_in) != len(t_in):
        raise MXNetError("alias(%r, %r): tensor-input arity mismatch (%d vs "
                         "%d)" % (name, target, len(n_in), len(t_in)))
    _OP_REGISTRY[name] = op


def list_ops():
    """The canonical names of every registered op, sorted."""
    return sorted(set(o.name for o in _OP_REGISTRY.values()))


def apply_op(name, *tensors, **attrs):
    """Apply a registered op to tensors: the attrs are canonicalised and
    the op's defaults filled in; returns what the op returns."""
    op = get(name)
    return op.fn(*tensors, **op.canonicalize_attrs(attrs))
