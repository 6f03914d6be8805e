"""Generate ``mx.sym.<op>`` from the op registry.

Counterpart of ``mxnet_tpu/symbol/register.py`` (reference:
python/mxnet/symbol/register.py): one function per registered op that
builds a graph node.  Positional Symbols (and lists of them) are the
op's inputs in order; the rest bind by name (``OP_INPUT_NAMES``); every
other keyword is an attribute, ``name=`` names the node.  A named input
left out becomes a ``<name>_<input>`` variable.
"""

from __future__ import annotations

from ..ops import custom as _custom
from ..ops import registry as _reg
from .symbol import Symbol, _create

__all__ = ["populate"]


def _make_sym_func(op_name):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("out", None)
        names = _reg.OP_INPUT_NAMES.get(op_name)
        if op_name == "Custom":  # the prop's arguments, by keyword
            names = _custom.input_names(
                {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol)})
        inputs = []
        for a in args:
            if isinstance(a, Symbol):
                inputs.append(a)
            elif a is None:
                # an absent optional input: its slot must be known by name
                if names is None or len(inputs) >= len(names):
                    raise TypeError("%s: positional arg %d is None but the "
                                    "input slot is unknown"
                                    % (op_name, len(inputs)))
                inputs.append(None)
            elif isinstance(a, (list, tuple)) and a \
                    and isinstance(a[0], Symbol):
                inputs.extend(a)
            else:
                raise TypeError("%s: positional args must be Symbols; pass "
                                "attrs as kwargs" % op_name)
        if names:
            for tn in names[len(inputs):]:
                if isinstance(kwargs.get(tn), Symbol):
                    inputs.append(kwargs.pop(tn))
                elif tn in kwargs and kwargs[tn] is None:
                    kwargs.pop(tn)
                elif any(isinstance(v, Symbol) for v in kwargs.values()):
                    continue
        else:
            for k in list(kwargs):
                if isinstance(kwargs[k], Symbol):
                    inputs.append(kwargs.pop(k))
        return _create(op_name, inputs, kwargs, name=name)

    fn.__name__ = fn.__qualname__ = op_name
    fn.__doc__ = (_reg.get(op_name).fn.__doc__ or "") + \
        "\n\n(a graph node; generated from the op registry)"
    return fn


def populate(namespace, names=None):
    """Install one function per registered op into ``namespace`` (an alias
    never replaces a name already there)."""
    for name in names or _reg.list_ops():
        op = _reg.get(name)
        f = _make_sym_func(name)
        namespace[name] = f
        for alias in op.aliases:
            namespace.setdefault(alias, f)
    return namespace
