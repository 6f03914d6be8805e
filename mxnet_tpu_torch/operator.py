"""``mx.operator``: Python custom operators of the PyTorch port.

Counterpart of ``mxnet_tpu/operator.py:29-159`` (reference:
python/mxnet/operator.py, ``CustomOp``, ``CustomOpProp``, ``register``).
A user subclasses :class:`CustomOpProp` (arguments, outputs, shapes,
types) and :class:`CustomOp` (``forward`` and ``backward`` on NDArrays,
writing results with :meth:`CustomOp.assign`), and registers the prop
under a name.  Registering installs ``mx.nd.<name>`` beside the registry
op ``mx.nd.Custom(..., op_type=name)``; ``mx.sym.Custom(...,
op_type=name)`` builds a graph node whose missing arguments (a softmax
head's ``label``) become ``<node>_<argument>`` variables, and whose
shapes come from the prop (:mod:`.ops.custom`).  The user's code runs on
the host, so an executor whose graph holds a custom op runs eagerly on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register", "get_custom_op"]

_REGISTRY = {}


class CustomOp:
    """Base of a user's operator (reference: operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` (an NDArray, a tensor or array-like) into the
        NDArray ``dst`` by ``req``: ``"write"``/``"inplace"`` copy,
        ``"add"`` adds, ``"null"`` does nothing."""
        if req == "null":
            return
        t = dst.data_torch
        if isinstance(src, NDArray):
            src = src.data_torch
        elif not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src))
        src = src.to(device=t.device, dtype=t.dtype)
        with torch.no_grad():
            if req in ("write", "inplace"):
                t.copy_(src)
            elif req == "add":
                t.add_(src)
            else:
                raise ValueError("assign: unknown req %r" % (req,))


class CustomOpProp:
    """What a custom op declares (reference: operator.py CustomOpProp):
    its arguments, outputs and auxiliary states, their shapes and types,
    and the operator it creates."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Decorator: register a :class:`CustomOpProp` subclass as
    ``reg_name`` and install ``mx.nd.<reg_name>`` (reference: operator.py
    register -> MXCustomOpRegister)."""

    def deco(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        _install(reg_name)
        return prop_cls

    return deco


def get_custom_op(name):
    """The prop class registered as ``name`` (KeyError when none is)."""
    return _REGISTRY[name]


def _install(reg_name):
    from . import ndarray as nd

    def fn(*inputs, **kwargs):
        kwargs["op_type"] = reg_name
        return nd.Custom(*inputs, **kwargs)

    fn.__name__ = fn.__qualname__ = reg_name
    fn.__doc__ = "The custom op %r (mx.nd.Custom(..., op_type=%r))." % (
        reg_name, reg_name)
    setattr(nd, reg_name, fn)
