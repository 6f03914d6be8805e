"""NDArray autograd of the port against the JAX package's: the first-order
cases of tests/test_autograd.py, run through both packages on the same
inputs, gradients compared within 1e-6 relative."""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

CPU = tmx.cpu()
PKGS = [(jmx.nd, jag, {}), (tnd, tag, {"ctx": CPU})]


def _both(fn):
    """``fn(nd, autograd, ctx_kw)`` in the JAX package, then the port; the
    results as numpy."""
    out = []
    for nd, ag, kw in PKGS:
        res = fn(nd, ag, kw)
        res = res if isinstance(res, (list, tuple)) else [res]
        out.append([r.asnumpy() if hasattr(r, "asnumpy") else np.asarray(r)
                    for r in res])
    return out


def _assert_same(fn):
    want, got = _both(fn)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_simple_grad():
    def run(nd, ag, kw):
        x = nd.array([1.0, 2.0, 3.0], **kw)
        x.attach_grad()
        with ag.record():
            y = (x * x * 2).sum()
        y.backward()
        return x.grad

    _assert_same(run)


def test_chain_rule():
    def run(nd, ag, kw):
        x = nd.array([[0.5, -1.0], [2.0, 0.0]], **kw)
        x.attach_grad()
        with ag.record():
            z = (nd.exp(x) * nd.sigmoid(x)).sum()
        z.backward()
        return x.grad

    _assert_same(run)


def test_multiple_variables():
    def run(nd, ag, kw):
        a, b = nd.array([1.0, 2.0], **kw), nd.array([3.0, 4.0], **kw)
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            c = (a * b + nd.tanh(a) / b).sum()
        c.backward()
        return a.grad, b.grad

    _assert_same(run)


def test_grad_req_add():
    def run(nd, ag, kw):
        w = nd.array([2.0, -1.0], **kw)
        w.attach_grad(grad_req="add")
        for _ in range(3):
            with ag.record():
                loss = (w * w).sum()
            loss.backward()
        return w.grad

    _assert_same(run)
    assert _both(run)[1][0].tolist() == [12.0, -6.0]


def test_grad_req_write_overwrites_the_same_buffer():
    w = tnd.array([2.0], ctx=CPU)
    w.attach_grad()
    g = w.grad
    for k in (1.0, 3.0):
        with tag.record():
            loss = (w * k).sum()
        loss.backward()
        assert g.asscalar() == k  # the buffer handed out stays current


def test_head_gradient():
    def run(nd, ag, kw):
        x = nd.array([1.0, 2.0], **kw)
        x.attach_grad()
        with ag.record():
            y = x * 3 + nd.square(x)
        y.backward(nd.array([10.0, 100.0], **kw))
        return x.grad

    _assert_same(run)


def test_grad_function():
    def run(nd, ag, kw):
        x = nd.array([3.0, -2.0], **kw)
        x.attach_grad()
        with ag.record():
            y = x * x * x
        return ag.grad(y, [x])[0], x.grad

    _assert_same(run)
    got = _both(run)[1]
    assert got[1].tolist() == [0.0, 0.0]  # grad() delivers to no buffer


def test_grad_of_an_unused_variable_raises():
    x, z = tnd.array([3.0], ctx=CPU), tnd.array([1.0], ctx=CPU)
    x.attach_grad()
    z.attach_grad()
    with tag.record():
        y = x * x
    with pytest.raises(tmx.MXNetError, match="does not participate"):
        tag.grad(y, [x, z])
    with pytest.raises(tmx.MXNetError, match="create_graph"):
        tag.grad(y, [x], create_graph=True)


def test_detach_stops_grad():
    def run(nd, ag, kw):
        x = nd.array([2.0], **kw)
        x.attach_grad()
        with ag.record():
            y = (x * x).detach() * x + nd.BlockGrad(x) * x
        y.backward()
        return x.grad

    _assert_same(run)


def test_training_modes():
    for _, ag, _ in PKGS:
        assert not ag.is_training()
        with ag.record():
            assert ag.is_training() and ag.is_recording()
            with ag.predict_mode():
                assert not ag.is_training() and ag.is_recording()
        with ag.pause():
            assert not ag.is_recording()
        with ag.record(train_mode=False):
            assert not ag.is_training()


def test_backward_without_record_raises():
    for nd, ag, kw in PKGS:
        x = nd.ones((2,), **kw)
        with pytest.raises((jmx.MXNetError, tmx.MXNetError)):
            x.backward()
    x = tnd.ones((2,), ctx=CPU)
    x.attach_grad()
    y = x * 2  # outside record: not differentiable
    with pytest.raises(tmx.MXNetError, match="recorded graph"):
        y.backward()


def test_retain_graph():
    def run(nd, ag, kw):
        x = nd.array([2.0, 5.0], **kw)
        x.attach_grad()
        with ag.record():
            y = x * x
        y.backward(retain_graph=True)
        g1 = x.grad.asnumpy().copy()
        y.backward()
        return g1, x.grad

    _assert_same(run)


def test_dropout_respects_modes():
    def run(nd, ag, kw):
        x = nd.ones((200,), **kw)
        with ag.record(train_mode=False):
            y = nd.Dropout(x, p=0.5)
        with ag.record():
            z = nd.Dropout(x, p=0.5)
        return y, (z.asnumpy() == 0).mean() > 0.2, \
            set(np.unique(z.asnumpy())) <= {0.0, 2.0}

    _assert_same(run)


def test_nn_ops_under_record():
    """FullyConnected -> gelu LeakyReLU -> FullyConnected -> residual ->
    LayerNorm, the feed-forward chip_smoke.py runs at full width."""
    rng = np.random.RandomState(5)
    vals = [rng.randn(*s).astype(np.float32) * 0.3 for s in
            ((2, 3, 8), (16, 8), (16,), (8, 16), (8,), (8,), (8,))]

    def run(nd, ag, kw):
        x, w1, b1, w2, b2, g, b = [nd.array(v, **kw) for v in vals]
        for p in (x, w1, b1, w2, b2, g, b):
            p.attach_grad()
        with ag.record():
            h = nd.FullyConnected(x, w1, b1, num_hidden=16, flatten=False)
            h = nd.LeakyReLU(h, act_type="gelu")
            h = nd.FullyConnected(h, w2, b2, num_hidden=8, flatten=False)
            out = nd.LayerNorm(h + x, g, b)
            loss = (out * out).sum()
        loss.backward()
        return [loss] + [p.grad for p in (x, w1, b1, w2, b2, g, b)]

    want, got = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_basic_index_autograd():
    def run(nd, ag, kw):
        x = nd.array(np.arange(20, dtype=np.float32).reshape(4, 5), **kw)
        x.attach_grad()
        with ag.record():
            loss = (x[:, 0:1] * 2).sum() + (x[:, 1:] * 3).sum() \
                + x[0, 2] + (x[1] * 5).sum() + (x[None, 2, ::2] * 7).sum() \
                + (x[::-1, 4] * 11).sum()
        loss.backward()
        return x.grad

    _assert_same(run)


def test_inplace_on_a_recorded_array_raises():
    """An in-place write on an array that requires grad, while recording,
    raises MXNetError naming the operation (never a bare torch error)."""
    x = tnd.array([1.0, 2.0], ctx=CPU)
    x.attach_grad()
    with tag.record():
        with pytest.raises(tmx.MXNetError, match="__iadd__"):
            x += 1
        with pytest.raises(tmx.MXNetError, match="__setitem__"):
            x[0] = 5
        y = x * 2
        with pytest.raises(tmx.MXNetError, match="__imul__"):
            y *= 3
        with pytest.raises(tmx.MXNetError, match="elemwise_add"):
            tnd.elemwise_add(x, x, out=x)
        with pytest.raises(tmx.MXNetError, match="sgd_update"):
            tnd.sgd_update(x, tnd.ones((2,), ctx=CPU), lr=0.1)
    assert x.asnumpy().tolist() == [1.0, 2.0]
    x += 1  # outside record an update in place is allowed (optimizers)
    assert x.asnumpy().tolist() == [2.0, 3.0]
    with tag.record():
        z = (x * x).sum()
    x[0] = 10  # modified after use: backward reports it as MXNetError
    with pytest.raises(tmx.MXNetError, match="backward"):
        z.backward()


def test_mark_variables_and_tensor_heads():
    x = tnd.array([1.0, 2.0], ctx=CPU)
    buf = tnd.zeros((2,), ctx=CPU)
    tag.mark_variables([x], [buf], "write")
    with tag.record():
        y = (x * x).data_torch.sum()  # a plain tensor head
    tag.backward(y)
    assert buf.asnumpy().tolist() == [2.0, 4.0]
    assert x.grad.data_torch is buf.data_torch
    with pytest.raises(tmx.MXNetError, match="grad_req"):
        tag.mark_variables([x], [buf], "bogus")
    with tag.record():
        with pytest.raises(tmx.MXNetError, match="detach"):
            tag.mark_variables([x * 2], [buf])


def test_torch_grad_mode_follows_the_recording_flag():
    x = tnd.array([1.0], ctx=CPU)
    x.attach_grad()
    torch.set_grad_enabled(True)  # PyTorch's global default
    assert not (x * 2).data_torch.requires_grad
    with tag.record():
        assert (x * 2).data_torch.requires_grad
        with tag.pause():
            assert not (x * 2).data_torch.requires_grad
