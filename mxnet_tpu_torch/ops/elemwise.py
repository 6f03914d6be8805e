"""Element-wise unary, binary, broadcast and scalar op families.

Counterpart of ``mxnet_tpu/ops/elemwise.py`` (reference: the
``elemwise_*_op_*.cc`` macro families): generated from tables of torch
callables, one row for each row of the JAX tables, under the same names
and aliases.  Where ``jnp`` and ``torch`` could differ, the JAX table
decides:

- ``round`` and ``rint`` round halves to even (``jnp.round``), not away
  from zero as MXNet's C++ does;
- ``mod`` is the floored modulo, with the sign of the divisor
  (``jnp.mod``, ``torch.remainder``); an integer modulo by 0 is 0, as in
  MXNet's ``mshadow_op::mod``;
- ``power`` of two integer operands is JAX's: binary exponentiation over
  the low six bits of the exponent, wrapping in the integer type;
- ``sign`` keeps NaN and the sign of a zero (``jnp.sign``); ``rint`` of
  integers is float32 (``jnp.rint``);
- float-to-integer casts saturate, NaN to 0 (``lax.convert_element_type``);
- comparisons and logical ops return 0/1 in the inputs' promoted dtype,
  ``isnan``/``isinf``/``isfinite`` return booleans;
- a Python scalar is a weak type, as in JAX: ``int32 + 2.5`` is float32,
  ``bf16 * 2.0`` stays bf16, and an integer scalar keeps an integer
  input's type, wrapping (``uint8 * 3``; torch's scalar promotion is the
  same);
- ``maximum``/``minimum`` propagate NaN;
- a bool operand gets the ``jnp`` result type: ``abs``, ``ceil``,
  ``floor``, ``trunc`` and ``fix`` keep it bool; ``relu``, ``square``,
  ``clip``, ``power`` and ``mod`` of bools are int32; a bool and a
  Python scalar compute in the scalar's weak type (``a - 3.0`` is
  float32); ``sign``, ``sigmoid`` and ``rsqrt`` raise on bool, as the JAX
  ops do (so do ``negative`` and ``sub`` of two bools).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import saturating_cast, torch_dtype
from .registry import register

__all__ = []


def _cbrt(x):
    x = x if x.is_floating_point() else x.float()
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _float(x):
    return x if x.is_floating_point() else x.float()


def _keep_bool(f):
    """``f``, except that a bool tensor comes back as a copy of itself
    (``jnp.abs``, ``jnp.floor``, ... of bools are bools)."""
    return lambda x: x.clone() if x.dtype == torch.bool else f(x)


def _int32_bool(f):
    """``f``, with a bool tensor taken as int32 first (``jnp.square`` or
    ``jax.nn.relu`` of bools are int32)."""
    return lambda x, *a: f(x.to(torch.int32) if x.dtype == torch.bool
                           else x, *a)


def _no_bool(name, f):
    """``f``, refusing bool tensors as the JAX op does."""
    def g(x):
        if x.dtype == torch.bool:
            raise TypeError("%s does not accept dtype bool" % name)
        return f(x)
    return g


def _sign(x):
    """``jnp.sign``: NaN and both zeros map to themselves."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


_UNARY = {
    "abs": _keep_bool(torch.abs),
    "sign": _no_bool("sign", _sign),
    "rint": lambda x: torch.round(_float(x)),
    "ceil": _keep_bool(torch.ceil),
    "floor": _keep_bool(torch.floor),
    "trunc": _keep_bool(torch.trunc),
    "fix": _keep_bool(torch.trunc),
    "round": torch.round,
    "square": _int32_bool(torch.square),
    "sqrt": lambda x: torch.sqrt(_float(x)),
    "rsqrt": _no_bool("rsqrt", lambda x: torch.rsqrt(_float(x))),
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": lambda x: torch.exp(_float(x)),
    "expm1": lambda x: torch.expm1(_float(x)),
    "log": lambda x: torch.log(_float(x)),
    "log10": lambda x: torch.log10(_float(x)),
    "log2": lambda x: torch.log2(_float(x)),
    "log1p": lambda x: torch.log1p(_float(x)),
    "sin": lambda x: torch.sin(_float(x)),
    "cos": lambda x: torch.cos(_float(x)),
    "tan": lambda x: torch.tan(_float(x)),
    "arcsin": lambda x: torch.arcsin(_float(x)),
    "arccos": lambda x: torch.arccos(_float(x)),
    "arctan": lambda x: torch.arctan(_float(x)),
    "sinh": lambda x: torch.sinh(_float(x)),
    "cosh": lambda x: torch.cosh(_float(x)),
    "tanh": lambda x: torch.tanh(_float(x)),
    "arcsinh": lambda x: torch.arcsinh(_float(x)),
    "arccosh": lambda x: torch.arccosh(_float(x)),
    "arctanh": lambda x: torch.arctanh(_float(x)),
    "degrees": lambda x: torch.rad2deg(_float(x)),
    "radians": lambda x: torch.deg2rad(_float(x)),
    "sigmoid": _no_bool("sigmoid", lambda x: torch.sigmoid(_float(x))),
    "softsign": lambda x: F.softsign(_float(x)),
    "relu": _int32_bool(torch.relu),
    "erf": lambda x: torch.erf(_float(x)),
    "erfinv": lambda x: torch.erfinv(_float(x)),
    "gamma": lambda x: torch.exp(torch.lgamma(_float(x))),
    "gammaln": lambda x: torch.lgamma(_float(x)),
    "digamma": lambda x: torch.digamma(_float(x)),
    "reciprocal": lambda x: 1.0 / x,
    "negative": torch.negative,
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
}


def _register_unary(name, f):
    @register(name, aliases=("_npi_" + name,))
    def _op(x, **_):
        """Element-wise unary op, generated from the _UNARY table."""
        return f(x)

    _op.__name__ = name
    _op.__doc__ = "Element-wise %s(x) (generated from the _UNARY table)." \
        % name
    return _op


for _n, _f in _UNARY.items():
    _register_unary(_n, _f)


@register("softrelu")
def softrelu(x, **_):
    """``log(1 + exp(x))``, computed stably (reference: mshadow_op::softrelu)."""
    return F.softplus(_float(x))


@register("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5, **_):
    """``clip(alpha * x + beta, 0, 1)`` (reference: hard_sigmoid-inl.h)."""
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register("clip")
def clip(x, a_min=None, a_max=None, **_):
    """Clamp every element into ``[a_min, a_max]`` (a bound of None is
    open)."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    if a_min is None and a_max is None:
        return x.clone()
    return torch.clamp(x, a_min, a_max)


@register("Cast", aliases=("cast",))
def cast(x, dtype="float32", **_):
    """Element type conversion to ``dtype`` (floats to ints truncate and
    saturate, NaN to 0)."""
    return saturating_cast(x, torch_dtype(dtype))


@register("_copy", aliases=("identity",))
def identity(x, **_):
    """A copy of ``x``."""
    return x.clone()


@register("BlockGrad", aliases=("stop_gradient", "block_grad"))
def stop_gradient(x, **_):
    """Identity forward, no gradient backward."""
    return x.detach()


@register("make_loss", aliases=("MakeLoss",))
def make_loss(x, **_):
    """Mark an output as a loss head: the identity, whose head gradient
    defaults to ones."""
    return x.view_as(x)


# ------------------------------------------- binary: elemwise_* and broadcast_*


def _ne0(t):
    return t != 0


def _is_int(dt):
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def _bools_int32(a, b):
    """Two bool operands as int32 (``jnp.mod``/``jnp.power`` of bools)."""
    if torch.result_type(a, b) == torch.bool:
        return a.to(torch.int32), (b.to(torch.int32)
                                   if isinstance(b, torch.Tensor) else b)
    return a, b


def _mod(a, b):
    """The floored modulo of a tensor by a tensor or a Python number; an
    integer divisor of 0 gives 0."""
    a, b = _bools_int32(a, b)
    if not _is_int(torch.result_type(a, b)):
        return torch.remainder(a, b)
    if not isinstance(b, torch.Tensor):
        b = _scalar_t(a, b)
    zero = b == 0
    return torch.where(zero, 0, torch.remainder(a, torch.where(zero, 1, b)))


def _int_pow(base, exp):
    """``jnp.power`` of integers: binary exponentiation over the exponent's
    low six bits, wrapping in the promoted integer type (``0 ** e`` is 0
    for ``e != 0``)."""
    dt = torch.result_type(base, exp)
    base, exp = torch.broadcast_tensors(base.to(dt), exp.to(dt))
    acc = torch.where((base == 0) & (exp != 0), 0, torch.ones_like(base))
    for bit in range(6):
        acc = torch.where(((exp >> bit) & 1) != 0, acc * base, acc)
        base = base * base
    return acc


def _power(a, b):
    a, b = _bools_int32(a, b)
    if _is_int(torch.result_type(a, b)):
        return _int_pow(a, b)
    return torch.pow(a, b)


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "mod": _mod,
    "power": _power,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": lambda a, b: torch.hypot(_float(a), _float(b)),
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
    "logical_and": lambda a, b: torch.logical_and(_ne0(a), _ne0(b)),
    "logical_or": lambda a, b: torch.logical_or(_ne0(a), _ne0(b)),
    "logical_xor": lambda a, b: torch.logical_xor(_ne0(a), _ne0(b)),
}

_BOOL_RESULT = {
    "equal", "not_equal", "greater", "greater_equal", "lesser",
    "lesser_equal", "logical_and", "logical_or", "logical_xor",
}


def _register_binary(name, f):
    bool_out = name in _BOOL_RESULT

    def _impl(a, b, **_):
        """Element-wise binary op, generated from the _BINARY table."""
        out = f(a, b)
        if bool_out:
            out = out.to(torch.result_type(a, b))
        return out

    _impl.__name__ = "elemwise_%s" % name
    _impl.__doc__ = ("Element-wise %s(lhs, rhs), registered as elemwise_%s "
                     "and broadcast_%s (both broadcast)%s."
                     % (name, name, name,
                        "; 0/1 in the inputs' dtype" if bool_out else ""))
    register("elemwise_%s" % name, aliases=("_%s" % name,))(_impl)
    register("broadcast_%s" % name)(_impl)
    return _impl


for _n, _f in _BINARY.items():
    _register_binary(_n, _f)


@register("_scatter_elemwise_div")
def scatter_elemwise_div(a, b, **_):
    """``a / b`` (dense; the reference keeps sparse storage)."""
    return a / b


# ------------------------------------------------------------ scalar family


def _scalar_t(x, s):
    """``s`` as a 0-d tensor of the dtype ``x op s`` has (``s`` is weak)."""
    return torch.tensor(s, dtype=torch.result_type(x, s), device=x.device)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": _mod,
    "_rmod_scalar": lambda x, s: _mod(_scalar_t(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: (
        _int_pow(_scalar_t(x, s), x) if _is_int(torch.result_type(x, s))
        else torch.pow(s, x)),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _scalar_t(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _scalar_t(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(_float(x),
                                              _scalar_t(_float(x), s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_logical_and_scalar": lambda x, s: (_ne0(x) & (s != 0)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: (_ne0(x) | (s != 0)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: (_ne0(x) ^ (s != 0)).to(x.dtype),
}


def _int_scalar(s):
    return isinstance(s, int) and not isinstance(s, bool)


# the scalar ops whose result on a bool tensor stays 0/1 in its dtype
_SCALAR_KEEPS_BOOL = {n for n in _SCALAR if "equal" in n or "greater" in n
                      or "lesser" in n or "logical" in n}


def _register_scalar(name, f):
    keeps_bool = name in _SCALAR_KEEPS_BOOL

    @register(name)
    def _op(x, scalar=0.0, **_):
        """Tensor-scalar element-wise op, from the _SCALAR table."""
        s = scalar if _int_scalar(scalar) else float(scalar)
        if x.dtype == torch.bool and not keeps_bool:
            # a bool computes in the scalar's weak type, as in jnp
            x = x.to(torch.int32 if _int_scalar(s) else torch.float32)
        return f(x, s)

    _op.__name__ = name
    _op.__doc__ = ("%s(x, scalar=...) per element; the scalar is a Python "
                   "int or float, weakly typed as in the JAX package "
                   "(generated from the _SCALAR table)." % name)
    return _op


for _n, _f in _SCALAR.items():
    _register_scalar(_n, _f)


@register("smooth_l1")
def smooth_l1(x, scalar=1.0, **_):
    """Smooth-L1 (Huber) loss with sigma = ``scalar``."""
    s2 = float(scalar) * float(scalar)
    x = _float(x)
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


# ------------------------------------------------------------- n-ary / misc


@register("add_n", aliases=("ElementWiseSum", "_sum_multi"))
def add_n(*args, **_):
    """Sum of same-shape tensors, added left to right."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("where")
def where(condition, x, y, **_):
    """``x`` where ``condition`` is nonzero, else ``y``; a 1-D condition
    selects whole rows."""
    if condition.dim() < x.dim() and condition.dim() == 1:
        condition = condition.reshape((condition.shape[0],)
                                      + (1,) * (x.dim() - 1))
    return torch.where(condition != 0, x, y)
