"""Generate ``mx.nd.<op>`` from the op registry.

Counterpart of ``mxnet_tpu/ndarray/register.py`` (reference:
python/mxnet/ndarray/register.py): one function per registered op, with
the same calling convention -- positional NDArrays (and lists of them),
then trailing scalars mapped onto the op's keyword parameters in order,
tensor inputs by keyword (``OP_INPUT_NAMES``), and ``out=``.
"""

from __future__ import annotations

import inspect

from ..ops import custom as _custom
from ..ops import registry as _reg
from ..ops.registry import OP_INPUT_NAMES as _TENSOR_KWARGS
from .ndarray import NDArray, imperative_invoke

__all__ = ["populate"]


def _scalar_param_names(op):
    """The op's non-tensor keyword parameters, in declaration order;
    optional tensor parameters (``bias=None``) are left out, so that a
    positional scalar never lands in a tensor slot."""
    tensor = set(_TENSOR_KWARGS.get(op.name, ()))
    return [p.name for p in inspect.signature(op.fn).parameters.values()
            if p.default is not inspect.Parameter.empty
            and p.name not in tensor]


def _make_op_func(op_name):
    op = _reg.get(op_name)
    tensor_names = _TENSOR_KWARGS.get(op_name)
    scalar_names = _scalar_param_names(op)

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        inputs = []
        scalar_pos = 0
        for a in args:
            if a is None:
                continue  # an omitted optional tensor (bias with no_bias)
            if isinstance(a, NDArray):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a \
                    and isinstance(a[0], NDArray):
                inputs.extend(a)
            else:
                while scalar_pos < len(scalar_names) \
                        and scalar_names[scalar_pos] in kwargs:
                    scalar_pos += 1
                if scalar_pos >= len(scalar_names):
                    raise TypeError("%s: too many positional arguments (got "
                                    "%r)" % (op_name, type(a)))
                kwargs[scalar_names[scalar_pos]] = a
                scalar_pos += 1
        names = tensor_names
        if op_name == "Custom":  # the prop's arguments, by keyword
            names = _custom.input_names(
                {k: v for k, v in kwargs.items()
                 if not isinstance(v, NDArray)})
        if names:
            for tn in names[len(inputs):]:
                if isinstance(kwargs.get(tn), NDArray):
                    inputs.append(kwargs.pop(tn))
                elif tn in kwargs and kwargs[tn] is None:
                    kwargs.pop(tn)
        else:
            for k in list(kwargs):
                if isinstance(kwargs[k], NDArray):
                    inputs.append(kwargs.pop(k))
        res = imperative_invoke(op_name, inputs, kwargs, out=out)
        return res[0] if len(res) == 1 else res

    fn.__name__ = fn.__qualname__ = op_name
    fn.__doc__ = (op.fn.__doc__ or "") + "\n\n(generated from the op registry)"
    return fn


def populate(namespace, names=None):
    """Install one function per registered op into ``namespace`` (an alias
    never replaces a name already there)."""
    for name in names or _reg.list_ops():
        op = _reg.get(name)
        f = _make_op_func(name)
        namespace[name] = f
        for alias in op.aliases:
            namespace.setdefault(alias, f)
    return namespace
