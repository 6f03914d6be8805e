"""The port's registry against the JAX package's where integers, NaN, the
infinities, a zero's sign or a divisor of 0 decide the result.

Each case runs ``jreg.get(name).fn`` and ``treg.apply_op`` on the same
numpy inputs, made from a seed or written out, and compares the result's
dtype and its values exactly: integers bit for bit, floats equal with NaN
in the same places and zeros of the same sign.  The last cases
(``Pooling`` with ``pool_type='lp'``, ``softmax`` and ``log_softmax`` of
integers) compare float32 values within 2e-6 relative: the two libraries
sum the windows and the exponentials in other orders, and ``pow`` may
differ by an ulp.
"""

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import cpu, nd as tnd
from mxnet_tpu_torch.ops import registry as treg

NAN, INF = float("nan"), float("inf")


def _jax(name, arrays, attrs):
    op = jreg.get(name)
    out = op.fn(*[jax.numpy.asarray(a) for a in arrays],
                **op.canonicalize_attrs(attrs))
    return np.asarray(out)


def _port(name, arrays, attrs):
    return treg.apply_op(name, *[torch.from_numpy(a.copy())
                                 for a in arrays], **attrs).numpy()


def _exactly(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(got, want)


def _ints(dtype, seed=3, shape=(3, 4)):
    rng = np.random.RandomState(seed)
    lo, hi = (0, 256) if dtype == "uint8" else (-128, 128)
    if dtype == "bool":
        return rng.randint(0, 2, shape).astype(bool)
    return rng.randint(lo, hi, shape).astype(dtype)


# the ten scalar ops of ROADMAP Queue 3 item 3: an integer scalar keeps an
# integer input's type and wraps (uint8 200 * 3 is 88)
SCALAR_OPS = ["_plus_scalar", "_minus_scalar", "_rminus_scalar",
              "_mul_scalar", "_mod_scalar", "_rmod_scalar", "_power_scalar",
              "_rpower_scalar", "_maximum_scalar", "_minimum_scalar"]


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
@pytest.mark.parametrize("name", SCALAR_OPS)
def test_integer_scalar_keeps_the_type_and_wraps(name, dtype):
    x = _ints(dtype)
    x.flat[:3] = [200 if dtype == "uint8" else 100, 0, 7]
    _exactly(_port(name, [x], {"scalar": 3}), _jax(name, [x], {"scalar": 3}))


@pytest.mark.parametrize("name", SCALAR_OPS)
def test_float_scalar_on_integers_gives_float32(name):
    x = np.array([[200, 3, 7, 1]], np.uint8)
    _exactly(_port(name, [x], {"scalar": 2.0}),
             _jax(name, [x], {"scalar": 2.0}))


@pytest.mark.parametrize("case", [
    ("_mod_scalar", np.array([5, -7, 0, 3], np.int32), 0),
    ("_rmod_scalar", np.array([5, -7, 0, 3], np.int32), 3),
    ("_rmod_scalar", np.array([0, 2, 0, 9], np.uint8), 0),
    ("_mod_scalar", np.array([0, 200, 7, 9], np.uint8), 0),
], ids=["mod-int32-by-0", "rmod-int32-at-0", "rmod-uint8-0-by-0",
        "mod-uint8-by-0"])
def test_scalar_integer_mod_by_zero_is_zero(case):
    name, x, s = case
    _exactly(_port(name, [x], {"scalar": s}), _jax(name, [x], {"scalar": s}))


@pytest.mark.parametrize("name", ["broadcast_mod", "elemwise_mod"])
@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8"])
def test_integer_mod_by_zero_is_zero(name, dtype):
    a = _ints(dtype, seed=5)
    b = _ints(dtype, seed=6)
    b[:, ::2] = 0
    if name == "broadcast_mod":
        b = b[:1]
    _exactly(_port(name, [a, b], {}), _jax(name, [a, b], {}))


@pytest.mark.parametrize("name", ["broadcast_power", "elemwise_power"])
@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8"])
def test_integer_power_is_jax_binary_exponentiation(name, dtype):
    """Negative exponents and exponents past 63 included: JAX takes the
    exponent's low six bits."""
    a = _ints(dtype, seed=8) % 7
    b = _ints(dtype, seed=9)
    _exactly(_port(name, [a, b], {}), _jax(name, [a, b], {}))


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "int32"])
@pytest.mark.parametrize("src", ["float32", "float16"])
def test_float_to_integer_cast_saturates(dtype, src):
    x = np.array([300.7, -1.5, NAN, INF, -INF, 1e10, -3e9, 127.9, -128.9,
                  255.5, -0.7, 2.9, 65504.0, -65504.0], np.float32)
    with np.errstate(over="ignore"):  # 1e10 and -3e9 are inf in float16
        x = x.astype(src)
    for name in ("Cast", "cast"):
        _exactly(_port(name, [x], {"dtype": dtype}),
                 _jax(name, [x], {"dtype": dtype}))


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
def test_ndarray_astype_saturates(dtype):
    x = np.array([[300.7, -1.5, NAN, INF], [-INF, 1e10, -3e9, 127.9]],
                 np.float32)
    want = jmx.nd.array(x).astype(dtype).asnumpy()
    got = tnd.array(x, ctx=cpu()).astype(dtype).asnumpy()
    _exactly(got, want)


# reductions (ROADMAP Queue 3 item 2): signed integers and booleans sum and
# multiply to int32, unsigned to uint32, wrapping; cumsum keeps the type
REDUCE_CASES = [
    ("prod", {}), ("prod", {"axis": 1}), ("nansum", {}),
    ("nansum", {"axis": 0}), ("nanprod", {"axis": 1}), ("sum", {}),
    ("sum", {"axis": 1, "keepdims": True}), ("norm", {"ord": 1}),
    ("norm", {"ord": 1, "axis": 1}), ("cumsum", {}), ("cumsum", {"axis": 1}),
]


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int32"])
@pytest.mark.parametrize("case", REDUCE_CASES,
                         ids=["%s%s" % (n, "-" + "-".join(
                             "%s%s" % kv for kv in sorted(a.items()))
                             if a else "") for n, a in REDUCE_CASES])
def test_integer_reduction_types(case, dtype):
    name, attrs = case
    x = _ints(dtype, seed=11, shape=(3, 6))
    _exactly(_port(name, [x], attrs), _jax(name, [x], attrs))


def test_integer_product_wraps():
    x = np.array([[70000, 70000, 3], [255, 255, 255]], np.int32)
    u = np.full((2, 5), 255, np.uint8)
    for a in (x, u):
        for name in ("prod", "nanprod"):
            _exactly(_port(name, [a], {"axis": 1}),
                     _jax(name, [a], {"axis": 1}))


def test_sign_keeps_nan_and_signed_zeros():
    x = np.array([NAN, -0.0, 0.0, -2.5, 3.0, -INF, INF], np.float32)
    _exactly(_port("sign", [x], {}), _jax("sign", [x], {}))
    for dtype in ("int32", "uint8", "int8"):
        a = _ints(dtype)
        _exactly(_port("sign", [a], {}), _jax("sign", [a], {}))


@pytest.mark.parametrize("dtype", ["int32", "uint8", "int8", "bool"])
def test_rint_of_integers_is_float32(dtype):
    x = _ints(dtype)
    _exactly(_port("rint", [x], {}), _jax("rint", [x], {}))


@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
@pytest.mark.parametrize("axis", [0, -1])
def test_softmax_of_integers_is_float32(name, axis):
    x = np.random.RandomState(4).randint(-6, 6, (3, 5)).astype(np.int32)
    got = _port(name, [x], {"axis": axis})
    want = _jax(name, [x], {"axis": axis})
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("p", [1, 2, 3, 2.5])
@pytest.mark.parametrize("window", [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)},
    {"kernel": (2, 2), "stride": (2, 2)},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
     "pooling_convention": "full"},
    {"kernel": (1, 1), "global_pool": True},
], ids=["3x3s2p1", "2x2s2", "3x3s2p1-full", "global"])
def test_lp_pooling(p, window):
    x = np.random.RandomState(2).randn(2, 7, 7, 3).astype(np.float32)
    attrs = dict(window, pool_type="lp", p_value=p, layout="NHWC")
    got, want = _port("Pooling", [x], attrs), _jax("Pooling", [x], attrs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_lp_pooling_default_p_is_two():
    x = np.random.RandomState(2).randn(2, 6, 6, 3).astype(np.float32)
    attrs = {"kernel": (2, 2), "pool_type": "lp", "layout": "NHWC"}
    np.testing.assert_allclose(_port("Pooling", [x], attrs),
                               _jax("Pooling", [x], attrs), rtol=2e-6,
                               atol=2e-6)
