"""``Custom``: a user's Python operator as a registered op of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/custom.py:19-112`` (reference:
src/operator/custom/custom.cc).  ``Custom(*arrays, op_type=name, **attrs)``
makes the :class:`~mxnet_tpu_torch.operator.CustomOpProp` registered as
``name`` (its attributes as strings, as MXNet hands them over), takes the
output and auxiliary shapes and types from its ``infer_shape`` and
``infer_type``, and calls the operator's ``forward`` on NDArrays over the
input tensors and over new zero outputs on the inputs' device.  When
PyTorch's grad mode is on and an input requires a gradient (an
``autograd.record`` scope, an executor's train forward) the op is a
``torch.autograd.Function`` whose backward calls the operator's
``backward`` with the output gradients (zeros where an output took none),
passed even when the prop says ``need_top_grad=False``, as the JAX
package passes them (``ops/custom.py:88-110``).  The user's code runs on
the host between device work, so a graph that holds ``Custom`` is never
captured (:func:`~mxnet_tpu_torch.executor.graph_capturable`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from .registry import register

__all__ = ["prop_for", "input_names", "infer"]


def prop_for(op_type, attrs):
    """The prop registered as ``op_type``, made from ``attrs`` (as
    strings)."""
    from ..operator import get_custom_op

    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    try:
        cls = get_custom_op(op_type)
    except KeyError:
        raise MXNetError("custom op %r is not registered "
                         "(mx.operator.register)" % (op_type,)) from None
    return cls(**{k: str(v) for k, v in attrs.items()})


def _split(attrs):
    attrs = dict(attrs)
    return attrs.pop("op_type", None), attrs


def _nout(attrs):
    return len(prop_for(*_split(attrs)).list_outputs())


def input_names(attrs):
    """The op's argument names (``prop.list_arguments()``)."""
    return tuple(prop_for(*_split(attrs)).list_arguments())


def infer(attrs, in_shapes, in_types=None):
    """``(arg shapes, out shapes, aux shapes, out types, aux types)`` by
    the prop's ``infer_shape`` and ``infer_type``; an unknown input shape
    is None (the prop may fill it, as a label's from the data's)."""
    prop = prop_for(*_split(attrs))
    shapes = [None if s is None else list(s) for s in in_shapes]
    args, outs, aux = prop.infer_shape(shapes)
    types = list(in_types or [np.dtype(np.float32)] * len(in_shapes))
    _, out_types, aux_types = prop.infer_type(types)
    tup = [None if s is None else tuple(int(d) for d in s) for s in args]
    return (tup, [tuple(int(d) for d in s) for s in outs],
            [tuple(int(d) for d in s) for s in aux],
            [np.dtype(t) for t in out_types],
            [np.dtype(t) for t in aux_types])


def _zeros(shapes, types, device):
    from ..ndarray import NDArray

    return [NDArray(torch.zeros(s, dtype=torch_dtype(t), device=device))
            for s, t in zip(shapes, types)]


class _Call:
    """One call's operator, shapes and types."""

    def __init__(self, op_type, attrs, arrays):
        prop = prop_for(op_type, attrs)
        in_shapes = [tuple(a.shape) for a in arrays]
        in_types = [np_dtype(a.dtype) for a in arrays]
        _, self.out_shapes, self.aux_shapes, self.out_types, \
            self.aux_types = infer(dict(attrs, op_type=op_type), in_shapes,
                                   in_types)
        self.device = arrays[0].device if arrays else torch.device("cpu")
        self.op = prop.create_operator(self.device, in_shapes, in_types)

    def forward(self, arrays, is_train):
        from .. import autograd
        from ..ndarray import NDArray

        outs = _zeros(self.out_shapes, self.out_types, self.device)
        self.aux = _zeros(self.aux_shapes, self.aux_types, self.device)
        with autograd.pause(train_mode=is_train):
            self.op.forward(is_train, ["write"] * len(outs),
                            [NDArray(a.detach()) for a in arrays], outs,
                            self.aux)
        return [o.data_torch for o in outs]

    def backward(self, ins, outs, grads):
        from .. import autograd
        from ..ndarray import NDArray

        out_grad = [NDArray(torch.zeros_like(o) if g is None else g)
                    for o, g in zip(outs, grads)]
        in_grad = [NDArray(torch.zeros_like(a)) for a in ins]
        with autograd.pause():
            self.op.backward(["write"] * len(ins), out_grad,
                             [NDArray(a) for a in ins],
                             [NDArray(o) for o in outs], in_grad, self.aux)
        return [g.data_torch for g in in_grad]


class _CustomFunction(torch.autograd.Function):
    """A recorded call: the user's ``forward``, whose backward is the
    user's ``backward``."""

    @staticmethod
    def forward(ctx, call, is_train, *arrays):
        outs = call.forward(arrays, is_train)
        ctx.call = call
        ctx.save_for_backward(*arrays, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        n_in = len(saved) - len(grads)
        in_grads = ctx.call.backward(saved[:n_in], saved[n_in:], grads)
        return (None, None) + tuple(
            g if ctx.needs_input_grad[2 + i] else None
            for i, g in enumerate(in_grads))


@register("Custom", num_outputs=_nout)
def custom(*arrays, op_type=None, **kwargs):
    """Run the CustomOp registered as ``op_type`` (``mx.operator.register``)
    on the host: never captured, differentiable through the user's
    ``backward`` (reference: operator/custom/custom.cc)."""
    from .. import autograd

    call = _Call(op_type, kwargs, arrays)
    is_train = autograd.is_training()
    if torch.is_grad_enabled() and any(a.requires_grad for a in arrays):
        outs = _CustomFunction.apply(call, is_train, *arrays)
    else:
        outs = call.forward(arrays, is_train)
    return tuple(outs) if len(outs) > 1 else outs[0]
