"""The port's autograd (mxnet_tpu_torch/autograd.py) and the gradient
attributes of its parameters (gluon/block.py Parameter) against the JAX
package's semantics: thread-local record/train flags, grad_req
'write'/'add'/'null', ones as the default head gradient, and no gradient
through work that was not recorded."""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch.gluon.nn import Dense


def _dense(seed=0):
    return Dense(3, in_units=4, device="cpu").initialize(seed=seed)


def _x(seed=1):
    return torch.from_numpy(np.random.RandomState(seed).normal(
        size=(2, 4)).astype(np.float32))


def test_scopes_set_and_restore_flags():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not autograd.is_training()
            assert not torch.is_grad_enabled()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
        assert autograd.is_recording() and autograd.is_training()
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    assert not autograd.is_recording() and not autograd.is_training()


def test_set_flags_return_the_old_value():
    net = _dense()
    assert autograd.set_recording(True) is False
    assert net(_x()).grad_fn is not None  # blocks follow the flag
    assert autograd.set_recording(False) is True
    assert net(_x()).grad_fn is None and torch.is_grad_enabled()
    assert autograd.set_training(True) is False
    assert autograd.set_training(False) is True
    assert not autograd.is_recording() and not autograd.is_training()


def test_flags_are_per_thread():
    seen = {}

    def other():
        seen["other"] = (autograd.is_recording(), autograd.is_training())

    with autograd.record():
        t = threading.Thread(target=other)
        t.start()
        t.join(30)
    assert not t.is_alive()
    assert seen["other"] == (False, False)


def test_flags_match_the_jax_package():
    cases = [(autograd.record, jag.record), (autograd.pause, jag.pause),
             (autograd.train_mode, jag.train_mode),
             (autograd.predict_mode, jag.predict_mode)]
    for port_scope, jax_scope in cases:
        with autograd.record(), jag.record():
            with port_scope(), jax_scope():
                assert (autograd.is_recording(), autograd.is_training()) \
                    == (jag.is_recording(), jag.is_training())


def test_write_replaces_and_add_accumulates():
    """Two backward calls before one step: 'write' keeps the second
    call's gradient, 'add' their sum."""
    net = _dense()
    x1, x2 = _x(1), _x(2)
    grads = {}
    for req in ("write", "add"):
        net.weight.grad_req = req
        net._parameters["weight"].grad = None
        for x in (x1, x2):
            with autograd.record():
                y = net(x)
            autograd.backward(y)
        grads[req] = net._parameters["weight"].grad.clone()
    one = {}
    for i, x in enumerate((x1, x2)):
        net.weight.grad_req = "write"
        with autograd.record():
            y = net(x)
        autograd.backward(y)
        one[i] = net._parameters["weight"].grad.clone()
    torch.testing.assert_close(grads["write"], one[1])
    torch.testing.assert_close(grads["add"], one[0] + one[1])


def test_default_head_gradient_is_ones():
    net = _dense()
    x = _x()
    with autograd.record():
        y = net(x)
    autograd.backward(y)
    # d(sum of y)/dW = sum over the batch of x, for every output row
    want = x.sum(0).expand(3, 4)
    torch.testing.assert_close(net._parameters["weight"].grad, want)
    torch.testing.assert_close(net._parameters["bias"].grad,
                               torch.full((3,), 2.0))


def test_head_gradients_match_the_jax_package():
    rng = np.random.RandomState(3)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    x = rng.normal(size=(2, 4)).astype(np.float32)
    hg = rng.normal(size=(2, 3)).astype(np.float32)
    jw = mx.nd.array(w)
    jw.attach_grad()
    with jag.record():
        jy = mx.nd.dot(mx.nd.array(x), jw.T)
    jag.backward(jy, head_grads=mx.nd.array(hg))
    net = Dense(3, in_units=4, use_bias=False, device="cpu")
    with torch.no_grad():
        net._parameters["weight"].copy_(torch.from_numpy(w))
    with autograd.record():
        y = net(torch.from_numpy(x))
    autograd.backward(y, head_grads=torch.from_numpy(hg))
    np.testing.assert_allclose(net._parameters["weight"].grad.numpy(),
                               jw.grad.asnumpy(),
                               rtol=1e-6, atol=1e-6)


def test_backward_on_unrecorded_output_raises():
    net = _dense()
    y = net(_x())
    assert y.grad_fn is None and not y.requires_grad
    with pytest.raises(MXNetError, match="recorded"):
        autograd.backward(y)
    with autograd.record():
        with autograd.pause():
            y = net(_x())
    with pytest.raises(MXNetError):
        autograd.backward(y)


def test_grad_req_null_gets_no_gradient():
    net = _dense()
    net.bias.grad_req = "null"
    assert not net._parameters["bias"].requires_grad
    with autograd.record():
        y = net(_x())
    autograd.backward(y)
    assert net._parameters["bias"].grad is None
    assert net._parameters["weight"].grad is not None
    with pytest.raises(ValueError):
        net.weight.grad_req = "sometimes"


def test_retain_graph_allows_a_second_backward():
    net = _dense()
    with autograd.record():
        y = net(_x())
    autograd.backward(y, retain_graph=True)
    first = net._parameters["weight"].grad.clone()
    autograd.backward(y)
    torch.testing.assert_close(net._parameters["weight"].grad, first)


def test_zero_grad_zeros_in_place():
    net = _dense()
    with autograd.record():
        y = net(_x())
    autograd.backward(y)
    g = net._parameters["weight"].grad
    net.zero_grad()
    assert net._parameters["weight"].grad is g and not g.any()
