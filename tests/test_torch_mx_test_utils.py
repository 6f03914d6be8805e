"""MXNet's test API in ``mxnet_tpu_torch.test_utils`` against the JAX
package's ``mxnet_tpu.test_utils`` on the same arrays.

The seeded shapes and arrays (both modules draw from one
``RandomState(1234)``, reseeded here) are equal; the comparisons give the
same verdicts and violations; the symbol checks pass and fail together,
and return the same values (1e-5); the default context follows the
scopes (``gpu(0)`` outside any, unless set); the synthetic MNIST arrays
and iterators are the JAX package's; ``download`` raises.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import test_utils as J
from mxnet_tpu_torch import test_utils as T

TOL = 1e-5


def _reseed():
    T._rng.seed(1234)
    J._rng.seed(1234)


@pytest.mark.parametrize("call", [
    lambda m: m.rand_shape_2d(),
    lambda m: m.rand_shape_2d(3, 50),
    lambda m: m.rand_shape_3d(4, 5, 6),
    lambda m: m.rand_shape_nd(4, 7),
    lambda m: m.random_arrays((2, 3)),
    lambda m: m.random_arrays((2, 3), (4,)),
    lambda m: m.rand_ndarray((3, 4)).asnumpy(),
    lambda m: m.rand_ndarray((3, 4), distribution="normal",
                             dtype=np.float64).asnumpy(),
], ids=["shape2d", "shape2d-dims", "shape3d", "shapend", "array",
        "arrays", "ndarray", "ndarray-normal"])
def test_seeded_shapes_and_arrays_equal_jax(call):
    _reseed()
    with tmx.cpu():
        got = [call(T), call(T)]
    want = [call(J), call(J)]
    for g, w in zip(got, want):
        if isinstance(w, list):
            for a, b in zip(g, w):
                assert np.array_equal(a, b) and a.dtype == b.dtype
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype
    assert T.default_dtype() == J.default_dtype()


def test_rand_ndarray_sparse_raises():
    with tmx.cpu(), pytest.raises(tmx.base.MXNetError, match="not ported"):
        T.rand_ndarray((3, 4), stype="csr")


@pytest.mark.parametrize("rtol,atol", [(None, None), (1e-3, 1e-6),
                                       (1e-7, 0.0)])
def test_comparisons_equal_jax(rtol, atol):
    rng = np.random.RandomState(0)
    a = rng.randn(4, 5).astype(np.float32)
    b = a + rng.randn(4, 5).astype(np.float32) * 1e-4
    b[2, 3] += 1e-2
    nan = a.copy()
    nan[0, 0] = np.nan
    with tmx.cpu():
        ta, tb = tmx.nd.array(a), tmx.nd.array(b)
    for x, y in ((ta, tb), (a, b), (ta, a)):
        jx = jmx.nd.array(np.asarray(x.asnumpy() if hasattr(x, "asnumpy")
                                     else x))
        jy = jmx.nd.array(np.asarray(y.asnumpy() if hasattr(y, "asnumpy")
                                     else y))
        assert T.almost_equal(x, y, rtol, atol) == \
            J.almost_equal(jx, jy, rtol, atol)
        assert T.same(x, y) == J.same(jx, jy)
        ti, tv = T.find_max_violation(x, y, rtol, atol)
        ji, jv = J.find_max_violation(jx, jy, rtol, atol)
        assert tuple(ti) == tuple(ji)
        np.testing.assert_allclose(tv, jv, rtol=1e-6)
        t_err = j_err = None
        try:
            T.assert_almost_equal(x, y, rtol, atol)
        except AssertionError as e:
            t_err = str(e).split(":")[0]
        try:
            J.assert_almost_equal(jx, jy, rtol, atol)
        except AssertionError as e:
            j_err = str(e).split(":")[0]
        assert t_err == j_err
    assert T.almost_equal(nan, nan, equal_nan=True) == \
        J.almost_equal(nan, nan, equal_nan=True)


def _fc_net(mx):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    return mx.sym.Activation(fc, act_type="tanh", name="act")


def _location(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(2, 4).astype(np.float32),
            "fc_weight": rng.randn(3, 4).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32)}


def test_symbolic_forward_backward_and_simple_forward_equal_jax():
    loc = _location()
    want = J.simple_forward(_fc_net(jmx), ctx=jmx.cpu(), **loc)
    got = T.simple_forward(_fc_net(tmx), ctx=tmx.cpu(), **loc)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    outs = T.check_symbolic_forward(_fc_net(tmx), loc, [want], atol=TOL,
                                    ctx=tmx.cpu())
    J.check_symbolic_forward(_fc_net(jmx), loc, [outs[0]], atol=TOL,
                             ctx=jmx.cpu())
    with pytest.raises(AssertionError):
        T.check_symbolic_forward(_fc_net(tmx), loc, [want + 1e-2],
                                 ctx=tmx.cpu())
    head = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    jgrads = J.check_symbolic_backward(_fc_net(jmx), loc, [head], {},
                                       ctx=jmx.cpu())
    tgrads = T.check_symbolic_backward(
        _fc_net(tmx), list(loc.values()), head,
        [jgrads[k] for k in _fc_net(tmx).list_arguments()], atol=TOL,
        ctx=tmx.cpu())
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=0, atol=TOL)
    with pytest.raises(AssertionError):
        T.check_symbolic_backward(_fc_net(tmx), loc, [head],
                                  {"fc_bias": jgrads["fc_bias"] + 1.0},
                                  ctx=tmx.cpu())


def test_numeric_gradient_passes_and_catches_a_wrong_gradient():
    loc = _location(2)
    T.check_numeric_gradient(_fc_net(tmx), loc, ctx=tmx.cpu(),
                             numeric_eps=1e-2, rtol=1e-2, atol=1e-3)
    J.check_numeric_gradient(_fc_net(jmx), loc, ctx=jmx.cpu(),
                             numeric_eps=1e-2, rtol=1e-2, atol=1e-3)
    # the missing weights drawn at their inferred shapes
    T.check_numeric_gradient(_fc_net(tmx), {"data": loc["data"]},
                             ctx=tmx.cpu(), numeric_eps=1e-2, atol=1e-3)
    # a graph whose gradient is wrong: BlockGrad hides the path
    bad = tmx.sym.BlockGrad(_fc_net(tmx)) + tmx.sym.Variable("data").sum()
    with pytest.raises(AssertionError):
        T.check_numeric_gradient(bad, loc, ctx=tmx.cpu(),
                                 numeric_eps=1e-2, atol=1e-3)


def test_consistency_checks_equal_jax():
    jres = J.check_consistency(_fc_net(jmx), [{"ctx": jmx.cpu(),
                                               "data": (2, 4)}])
    tres = T.check_consistency(_fc_net(tmx), [{"ctx": tmx.cpu(),
                                               "data": (2, 4)},
                                              {"ctx": tmx.cpu(),
                                               "data": (2, 4)}])
    assert len(tres) == 2 and len(jres) == 1
    assert np.array_equal(tres[0][0], tres[1][0])
    rng = np.random.RandomState(3)
    for op, arrays, attrs in (
            ("FullyConnected", [rng.randn(2, 4), rng.randn(3, 4),
                                rng.randn(3)], {"num_hidden": 3}),
            ("softmax", [rng.randn(3, 5)], {"axis": 1}),
            ("LayerNorm", [rng.randn(2, 3, 4), rng.randn(4), rng.randn(4)],
             {"eps": 1e-3}),
            ("Pad", [rng.randn(1, 2, 3, 4)],
             {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)})):
        arrays = [a.astype(np.float32) for a in arrays]
        got = T.check_op_consistency(op, arrays, attrs)
        want = J.check_op_consistency(op, arrays, attrs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=TOL * max(1, np.abs(w).max()))


def test_default_context_follows_the_scopes():
    assert T.default_context() == tmx.gpu(0)
    with tmx.cpu():
        assert T.default_context() == tmx.cpu()
        with jmx.cpu():
            assert str(T.default_context()) == str(J.default_context())
    T.set_default_context(tmx.cpu())
    try:
        assert T.default_context() == tmx.cpu()
        assert T.rand_ndarray((2, 2)).context == tmx.cpu()
        with tmx.gpu(0):
            assert T.default_context() == tmx.gpu(0)
    finally:
        T.set_default_context(None)
    assert T.default_context() == tmx.gpu(0)


def test_mnist_arrays_and_iterators_equal_jax():
    got, want = T.get_mnist(), J.get_mnist()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    with tmx.cpu():
        ttrain, tval = T.get_mnist_iterator(50, (784,))
        tb = next(iter(tval))
        dummy = T.DummyIter(iter(tval))
        assert next(dummy) is next(dummy)
    jtrain, jval = J.get_mnist_iterator(50, (784,))
    jb = next(iter(jval))
    assert ttrain.provide_data[0].shape == jtrain.provide_data[0].shape
    assert np.array_equal(tb.data[0].asnumpy(), jb.data[0].asnumpy())
    assert np.array_equal(tb.label[0].asnumpy(), jb.label[0].asnumpy())
    assert dummy.batch_size == 50


def test_download_raises():
    with pytest.raises(RuntimeError, match="downloads nothing"):
        T.download("http://data.mxnet.io/mnist.zip")
    with pytest.raises(RuntimeError):
        J.download("http://data.mxnet.io/mnist.zip")
