"""Advanced activation layers of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py`` (reference:
python/mxnet/gluon/nn/activations.py): ``LeakyReLU``, ``PReLU`` (a learned
slope, the parameter ``alpha``), ``ELU``, ``SELU``, ``GELU`` and
``Swish``, each over the registered ``LeakyReLU`` op (Swish: ``x *
sigmoid(beta * x)``), so they run on tensors, NDArrays and Symbols.
"""

from __future__ import annotations

from ... import initializer as _init
from ..block import BoundOp, HybridBlock

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish"]


class _Activation(HybridBlock):
    """One registered op of the input, its attributes bound when built."""

    _port_native = True
    _placeless = True

    def __init__(self, op, prefix=None, params=None, **attrs):
        super().__init__(prefix=prefix, params=params)
        self._op = BoundOp(op, **attrs)

    def hybrid_forward(self, F, x):
        return self._op(F, x)


class LeakyReLU(_Activation):
    """``x`` where positive, else ``alpha * x``."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__("LeakyReLU", prefix, params, act_type="leaky",
                         slope=alpha)
        self._alpha = alpha

    def __repr__(self):
        return "LeakyReLU(%s)" % self._alpha


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of shape (1,) (default
    0.25), shared by every channel."""

    _port_native = True

    def __init__(self, alpha_initializer=None, prefix=None, params=None, *,
                 device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._param("alpha", (1,),
                    init=alpha_initializer or _init.Constant(0.25))
        self._op = BoundOp("LeakyReLU", act_type="prelu")

    def hybrid_forward(self, F, x, alpha):
        return self._op(F, x, alpha)


class ELU(_Activation):
    """``x`` where positive, else ``alpha * (exp(x) - 1)``."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__("LeakyReLU", prefix, params, act_type="elu",
                         slope=alpha)


class SELU(_Activation):
    """The scaled ELU of Klambauer et al."""

    def __init__(self, prefix=None, params=None):
        super().__init__("LeakyReLU", prefix, params, act_type="selu")


class GELU(_Activation):
    """The exact GELU, ``x * Phi(x)``."""

    def __init__(self, prefix=None, params=None):
        super().__init__("LeakyReLU", prefix, params, act_type="gelu")


class Swish(_Activation):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__("sigmoid", prefix, params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * self._op(F, self._beta * x)
