"""The port's NDArray against the JAX package's: the cases of
tests/test_ndarray.py run through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` on the same inputs.

Tolerances: float32 within 1e-6 relative (1e-5 for reductions and dot);
integer and index results exactly.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

CPU = tmx.cpu()


def _both(fn):
    """``fn(nd, ctx_kw)`` through the JAX package and through the port."""
    return fn(jmx.nd, {}), fn(tnd, {"ctx": CPU})


def _close(got, want, tol=1e-6):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(got, want)


def test_creation():
    def run(nd, kw):
        return [nd.zeros((2, 3), **kw), nd.ones((4,), dtype="int32", **kw),
                nd.full((2, 2), 7.5, **kw), nd.array([[1, 2], [3, 4]], **kw),
                nd.empty((2, 1), **kw),
                nd.arange(1, 7, 2, repeat=2, **kw)]

    want, got = _both(run)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w)
    assert got[3].size == 4 and got[3].ndim == 2
    assert isinstance(got[0], tnd.NDArray) and got[0].context == CPU


def test_default_context_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="device='cpu'"):
        tnd.zeros((2,))
    with pytest.raises(tmx.MXNetError, match="device='cpu'"):
        tnd.array([1.0])


def test_arithmetic():
    a = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    b = np.array([[4.0, 3.0], [2.0, 1.0]], np.float32)

    def run(nd, kw):
        x, y = nd.array(a, **kw), nd.array(b, **kw)
        return [x + y, x - y, x * 2 + 1, 1.0 / x, x ** 2, 2 - x, x > 2,
                x % 1.5, -x, abs(-x), 2 ** x, x == y, x != 2, x <= y,
                x / y, x * y, 3 % x, nd.maximum(x, 2.5), nd.minimum(1.5, y),
                nd.maximum(x, y)]

    want, got = _both(run)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(g, w)


def test_int_arithmetic_follows_the_jax_scalar_rule():
    """A Python scalar is a float attribute, so int32 + 1 is float32 in
    both packages; int32 + int32 stays int32."""
    a = np.arange(6, dtype=np.int32).reshape(2, 3)

    def run(nd, kw):
        x = nd.array(a, **kw)
        return [x + 1, x * x, x - x]

    want, got = _both(run)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(g, w)


def test_inplace():
    a = tnd.ones((3,), ctx=CPU)
    a += 2
    assert (a.asnumpy() == 3).all()
    a *= 2
    assert (a.asnumpy() == 6).all()
    a /= 3
    assert (a.asnumpy() == 2).all()
    a -= tnd.array([1.0, 0.0, 1.0], ctx=CPU)
    assert a.asnumpy().tolist() == [1.0, 2.0, 1.0]


def test_indexing():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)

    def run(nd, kw):
        a = nd.array(x, **kw)
        # read at once: a view of the port follows later writes to ``a``
        out = [v.asnumpy() for v in (a[1], a[1, 2], a[0:2], a[:, 1:3],
                                     a[-1], a[None, 1])]
        a[0, 0] = 100.0
        a[1] = 0
        idx = nd.array([0, 2], dtype="int32", **kw)
        return out + [a.copy(), a[idx], a[nd.array([2.7, -1.0], **kw)],
                      a[::2, ::-1]]

    want, got = _both(run)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[1].item() == 6


def test_view_writeback():
    """Basic indexing gives a torch view: writes through a slice (``[]=``
    and ``+=``) reach the parent; advanced indexing gives a copy."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)

    def run(nd, kw):
        a = nd.array(x, **kw)
        v = a[0:1]
        v[:] = -1
        w = a[1]
        w[1:] = 7
        return a

    want, got = _both(run)
    _close(got, want)
    a = tnd.array(x, ctx=CPU)
    v = a[1]
    v += 10
    assert a.asnumpy()[1].tolist() == [13.0, 14.0, 15.0]
    assert v.data_torch._base is a.data_torch
    c = a[tnd.array([0], dtype="int32", ctx=CPU)]
    c[:] = 0
    assert a.asnumpy()[0].tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(tmx.MXNetError, match="negative step"):
        a[:, ::-1] = 0


def test_reshape_transpose():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)

    def run(nd, kw):
        a = nd.array(x, **kw)
        return [a.reshape((3, 2)), a.reshape((-1,)), a.T, a.reshape((0, -1)),
                nd.Reshape(a, shape=(-2,)), a.expand_dims(0),
                a.expand_dims(0).squeeze(0), a.reshape(3, 2),
                a.transpose((1, 0)), a.flatten(), a.flip(1),
                nd.moveaxis(a, 0, 1)]

    want, got = _both(run)
    for g, w in zip(got, want):
        _close(g, w)


def test_op_results_never_alias_their_input():
    """Ops return new arrays as in the JAX package, even where torch gives
    a view (reshape, transpose, Dropout outside training)."""
    a = tnd.array(np.ones((2, 3), np.float32), ctx=CPU)
    for out in (a.reshape((3, 2)), a.T, tnd.Dropout(a), tnd.BlockGrad(a),
                tnd.identity(a), tnd.expand_dims(a, axis=0)):
        out[:] = 5
    assert (a.asnumpy() == 1).all()


def test_reductions():
    x = np.random.RandomState(0).rand(3, 4, 5).astype(np.float32)

    def run(nd, kw):
        a = nd.array(x, **kw)
        return [a.sum(), a.sum(axis=1), a.mean(axis=(0, 2)), a.max(axis=0),
                a.min(), nd.sum(a, axis=1, exclude=True), a.argmax(axis=2),
                a.prod(axis=1), a.norm(), a.argmin(axis=0, keepdims=True),
                nd.sum_axis(a, axis=2), a.sum(dtype="float64")]

    want, got = _both(run)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(g, w, 1e-5)


def test_dot():
    rng = np.random.RandomState(1)
    a, b = rng.rand(4, 5).astype(np.float32), rng.rand(5, 3).astype(np.float32)
    x, y = rng.rand(2, 4, 5).astype(np.float32), \
        rng.rand(2, 5, 3).astype(np.float32)

    def run(nd, kw):
        return [nd.dot(nd.array(a, **kw), nd.array(b, **kw)),
                nd.dot(nd.array(a, **kw), nd.array(b.T, **kw),
                       transpose_b=True),
                nd.dot(nd.array(a.T, **kw), nd.array(b, **kw),
                       transpose_a=True),
                nd.batch_dot(nd.array(x, **kw), nd.array(y, **kw)),
                nd.array(a, **kw).dot(nd.array(b, **kw)),
                nd.array(x, **kw) @ nd.array(y, **kw)]

    want, got = _both(run)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_concat_split_stack():
    def run(nd, kw):
        a, b = nd.ones((2, 3), **kw), nd.zeros((2, 3), **kw)
        c = nd.concat(a, b, dim=0)
        parts = nd.split(c, num_outputs=2, axis=0)
        return [c, parts[0], parts[1], nd.stack(a, b, axis=0),
                nd.concatenate([a, b], axis=1), nd.stack_arrays([a, b], 1),
                c.split(2, axis=0, squeeze_axis=False)[1]]

    want, got = _both(run)
    for g, w in zip(got, want):
        _close(g, w)


def test_copyto_and_context():
    a = tnd.ones((2, 2), ctx=CPU)
    b = tnd.zeros((2, 2), ctx=CPU)
    assert a.copyto(b) is b
    assert (b.asnumpy() == 1).all()
    assert a.as_in_context(CPU) is a and a.context.type == "cpu"
    c = a.copyto(CPU)
    c[:] = 3
    assert (a.asnumpy() == 1).all()
    d = tnd.zeros((2, 2), dtype="int32", ctx=CPU)
    tnd.array([[1.7, 2.2], [3.0, -1.5]], ctx=CPU).copyto(d)
    assert d.asnumpy().tolist() == [[1, 2], [3, -1]]
    with pytest.raises(ValueError, match="shape"):
        a.copyto(tnd.zeros((3,), ctx=CPU))


@pytest.mark.parametrize("fmt", ["dict", "list"])
def test_save_load_across_packages(tmp_path, fmt):
    """nd.save of either package loads into the other's nd.load; the port
    saves NDArrays, tensors and numpy arrays and loads NDArrays."""
    rng = np.random.RandomState(2)
    vals = {"w": rng.randn(3).astype(np.float32),
            "b": rng.randint(0, 5, (2, 2)).astype(np.int32)}
    t_src = {"w": tnd.array(vals["w"], ctx=CPU),
             "b": torch.from_numpy(vals["b"])}
    j_src = {k: jmx.nd.array(v) for k, v in vals.items()}
    if fmt == "list":
        t_src, j_src = list(t_src.values()), list(j_src.values())
    tpath, jpath = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tnd.save(tpath, t_src)
    jmx.nd.save(jpath, j_src)
    for got, want in ((tnd.load(jpath, ctx=CPU), jmx.nd.load(tpath)),):
        if fmt == "dict":
            assert set(got) == set(want) == {"w", "b"}
            items = [(got[k], want[k], vals[k]) for k in vals]
        else:
            items = list(zip(got, want, vals.values()))
        for g, w, v in items:
            assert isinstance(g, tnd.NDArray)
            np.testing.assert_array_equal(g.asnumpy(), v)
            np.testing.assert_array_equal(w.asnumpy(), v)
    tnd.save(str(tmp_path / "one"), np.ones(3, np.float32))
    assert tnd.load(str(tmp_path / "one"), ctx=CPU)[0].shape == (3,)


def test_astype_dtypes():
    a = tnd.ones((2, 2), ctx=CPU)
    assert a.astype("float16").dtype == np.float16
    assert a.astype(np.int32).dtype == np.int32
    assert a.astype("bfloat16").dtype == torch.bfloat16
    assert a.astype("bfloat16").asnumpy().dtype == np.float32
    assert a.astype("float32", copy=False) is a


def test_wait_sync():
    a = tnd.ones((10, 10), ctx=CPU)
    b = a * 2
    b.wait_to_read()
    tnd.waitall()
    assert (b.asnumpy() == 2).all()


def test_take_onehot_pick():
    w = np.arange(12, dtype=np.float32).reshape(4, 3)

    def run(nd, kw):
        idx = nd.array([0, 2], dtype="int32", **kw)
        x = nd.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], **kw)
        return [nd.take(nd.array(w, **kw), idx), nd.one_hot(idx, depth=4),
                nd.pick(x, nd.array([0, 2], **kw), axis=1),
                nd.array(w, **kw).take(idx), idx.one_hot(3),
                x.pick(nd.array([1, 1], **kw), axis=1, keepdims=True)]

    want, got = _both(run)
    for g, w_ in zip(got, want):
        _close(g, w_)
    assert got[1].asnumpy()[1, 2] == 1.0


def test_fluent_methods():
    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)

    def run(nd, kw):
        a = nd.array(x, **kw)
        return [a.abs(), a.square(), a.abs().sqrt(), a.exp(), a.abs().log(),
                a.sigmoid(), a.tanh(), a.relu(), a.softmax(), a.log_softmax(),
                a.clip(-0.5, 0.5), a.round(), a.sign(), a.sort(),
                a.argsort(), a.topk(k=2), a.expand_dims(0).broadcast_to((2, 3, 4)),
                a.tile((2, 1)), a.repeat(2, axis=1), a.slice((1, 0), (3, 2)),
                a.slice_axis(1, 1, 3), a.reshape_like(nd.zeros((4, 3), **kw)),
                a[0:1].broadcast_like(a), a.mean(axis=1, keepdims=True),
                a.max(axis=1), a.min(axis=0), a.prod()]

    want, got = _both(run)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(g, w, 1e-5)


def test_numpy_interop_and_scalars():
    a = tnd.array([[1.0, 2.0]], ctx=CPU)
    assert np.asarray(a).tolist() == [[1.0, 2.0]]
    assert bool(tnd.array([3.0], ctx=CPU)) and len(a) == 1
    with pytest.raises(ValueError):
        bool(a)
    assert [r.shape for r in a] == [(2,)]
    assert (a + np.array([1.0, 1.0])).asnumpy().tolist() == [[2.0, 3.0]]
    t = torch.arange(3.0)
    n = tnd.NDArray(t)
    assert n.data_torch is t  # zero-copy both ways
    n[0] = 9
    assert t[0] == 9
    with pytest.raises(TypeError, match="torch.Tensor"):
        tnd.NDArray(np.ones(2))


def test_error_on_unknown_op():
    with pytest.raises(tmx.MXNetError):
        tnd.imperative_invoke("BogusOp", [], {})
    with pytest.raises(tmx.MXNetError, match="Reshape"):
        tnd.Reshape(tnd.ones((2, 3), ctx=CPU), shape=(4, 4))
    with pytest.raises(TypeError, match="too many positional"):
        tnd.relu(tnd.ones((2,), ctx=CPU), 1.0)


def test_positional_scalars_and_out():
    """mx.nd.<op>: trailing scalars fill the op's keyword parameters in
    order, ``out=`` receives the result."""
    x = np.linspace(-2, 2, 8, dtype=np.float32)

    def run(nd, kw):
        a = nd.array(x, **kw)
        out = nd.zeros((8,), **kw)
        nd.clip(a, -1.0, 0.5, out=out)
        return [nd.clip(a, -0.5, 1.0), out]

    want, got = _both(run)
    for g, w in zip(got, want):
        _close(g, w)


def test_random_module():
    tmx.random.seed(11)
    u = tnd.random.uniform(-1, 1, shape=(2000,), ctx=CPU)
    n = tnd.random.normal(2.0, 0.5, shape=(50, 40), ctx=CPU)
    r = tnd.random.randn(3, 4, ctx=CPU)
    i = tnd.random.randint(0, 5, shape=(1000,), ctx=CPU)
    assert u.shape == (2000,) and -1 <= u.min().asscalar() < 1
    assert abs(n.mean().asscalar() - 2.0) < 0.1 and r.shape == (3, 4)
    assert i.dtype == np.int32 and set(np.unique(i.asnumpy())) == set(range(5))
    out = tnd.zeros((4, 3), ctx=CPU)
    assert tnd.random.uniform(5, 6, out=out) is out
    assert (out.asnumpy() >= 5).all()
    d = tnd.array(np.arange(10, dtype=np.float32), ctx=CPU)
    s = tnd.random.shuffle(d)
    assert sorted(s.asnumpy().tolist()) == list(range(10))
    tmx.random.seed(11)
    again = tnd.random.uniform(-1, 1, shape=(2000,), ctx=CPU)
    np.testing.assert_array_equal(again.asnumpy(), u.asnumpy())
    with pytest.raises(tmx.MXNetError, match="not ported"):
        tnd.random.uniform(tnd.zeros((2,), ctx=CPU), 1.0)
    with pytest.raises(tmx.MXNetError, match="scale"):
        tnd.random.normal(0.0, -1.0, ctx=CPU)


def test_gluon_parameters_cross_into_nd():
    """A Gluon parameter and its gradient are NDArrays without a copy, so
    an imperative update reaches the block."""
    from mxnet_tpu_torch.gluon.nn import Dense

    net = Dense(3, in_units=4, device="cpu").initialize(seed=1)
    x = torch.ones(2, 4)
    with tag.record():
        loss = net(x).sum()
    tag.backward(loss)
    w, g = tnd.NDArray(net.weight), tnd.NDArray(net.weight.grad)
    before = net.weight.detach().clone()
    tnd.sgd_update(w, g, lr=0.5)
    torch.testing.assert_close(net.weight.detach(), before - 0.5 * g.data_torch)
