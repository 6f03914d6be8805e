"""The port's loss, optimizer update ops, pick, log_softmax and Dropout
against the JAX package's on identical numpy inputs.

Tolerances: 1e-5 for the loss (a log-softmax over a row of 11 in float32,
reduced in another order); 1e-6 for one optimizer step (the same float32
element-wise formulas in the same order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgl
from mxnet_tpu.ops import matrix as jmatrix
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import optimizer_ops as jops
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon.nn import Dropout
from mxnet_tpu_torch.ops import matrix as tmatrix
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import optimizer_ops as tops

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
B, S, C = 3, 5, 11


def _normal(shape, seed):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _labels(seed, low=0, high=C):
    return np.random.RandomState(seed).randint(low, high, size=(B, S)) \
        .astype(np.float32)


def _both(jax_loss, port_loss, pred, label, sample_weight=None):
    args = [pred, label] + ([sample_weight] if sample_weight is not None
                            else [])
    want = jax_loss(*(mx.nd.array(a) for a in args)).asnumpy()
    got = port_loss(*(torch.from_numpy(np.ascontiguousarray(a))
                      for a in args)).numpy()
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, **LOSS_TOL)


@pytest.mark.parametrize("kw", [{}, {"weight": 0.5}, {"batch_axis": 0}])
def test_softmax_ce_sparse_labels(kw):
    _both(jgl.loss.SoftmaxCrossEntropyLoss(**kw),
          gluon.loss.SoftmaxCrossEntropyLoss(**kw),
          _normal((B, S, C), 0), _labels(1))


def test_softmax_ce_dense_labels():
    dist = np.abs(_normal((B, S, C), 2))
    dist /= dist.sum(-1, keepdims=True)
    _both(jgl.loss.SoftmaxCrossEntropyLoss(sparse_label=False),
          gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False),
          _normal((B, S, C), 3), dist)


def test_softmax_ce_from_logits():
    logp = np.asarray(jnn.log_softmax(jnp.asarray(_normal((B, S, C), 4))))
    _both(jgl.loss.SoftmaxCrossEntropyLoss(from_logits=True),
          gluon.loss.SoftmaxCrossEntropyLoss(from_logits=True),
          logp, _labels(5))


def test_softmax_ce_sample_weight():
    _both(jgl.loss.SoftmaxCrossEntropyLoss(),
          gluon.loss.SoftmaxCrossEntropyLoss(),
          _normal((B, S, C), 6), _labels(7),
          np.abs(_normal((B, S, 1), 8)))


def test_softmax_ce_clips_out_of_range_labels():
    label = _labels(9, low=-4, high=C + 4)
    label[0, 0] = 2.7  # truncated toward zero
    assert (label < 0).any() and (label >= C).any()
    _both(jgl.loss.SoftmaxCrossEntropyLoss(),
          gluon.loss.SoftmaxCrossEntropyLoss(),
          _normal((B, S, C), 10), label)


def test_softmax_ce_alias_and_gradient():
    assert gluon.loss.SoftmaxCELoss is gluon.loss.SoftmaxCrossEntropyLoss
    pred = torch.from_numpy(_normal((B, S, C), 11)).requires_grad_()
    label = torch.from_numpy(_labels(12))
    with autograd.record():
        loss = gluon.loss.SoftmaxCELoss()(pred, label)
    loss.sum().backward()
    want = (torch.softmax(pred.detach(), -1)
            - torch.nn.functional.one_hot(label.long(), C)) / S
    torch.testing.assert_close(pred.grad, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("axis", [-1, 1])
def test_pick_matches_jax(mode, axis):
    data = _normal((B, S, C), 13)
    shape = (B, C) if axis == 1 else (B, S)
    n = S if axis == 1 else C
    idx = np.random.RandomState(14).randint(-2 * n, 2 * n, size=shape) \
        .astype(np.float32)
    for keepdims in (False, True):
        want = np.asarray(jmatrix.pick(jnp.asarray(data), jnp.asarray(idx),
                                       axis=axis, keepdims=keepdims,
                                       mode=mode))
        got = tmatrix.pick(torch.from_numpy(data), torch.from_numpy(idx),
                           axis=axis, keepdims=keepdims, mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [-1, 1])
def test_log_softmax_matches_jax(axis):
    x = _normal((B, S, C), 15)
    want = np.asarray(jnn.log_softmax(jnp.asarray(x), axis=axis))
    got = tnn.log_softmax(torch.from_numpy(x), axis=axis)
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)


def _opt_inputs(seed, n=3):
    return [_normal((4, 6), seed + i) for i in range(n)]


@pytest.mark.parametrize("clip", [-1.0, 0.05])
def test_sgd_update_matches_jax(clip):
    w, g = _opt_inputs(20, 2)
    kw = dict(lr=0.1, wd=1e-3, rescale_grad=0.25, clip_gradient=clip)
    want = np.asarray(jops.sgd_update(jnp.asarray(w), jnp.asarray(g), **kw))
    tw = torch.from_numpy(w.copy())
    tops.sgd_update(tw, torch.from_numpy(g), **kw)
    np.testing.assert_allclose(tw.numpy(), want, **OPT_TOL)


@pytest.mark.parametrize("clip", [-1.0, 0.05])
def test_sgd_mom_update_matches_jax(clip):
    w, g, m = _opt_inputs(30)
    kw = dict(lr=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.25,
              clip_gradient=clip)
    want_w, want_m = jops.sgd_mom_update(jnp.asarray(w), jnp.asarray(g),
                                         jnp.asarray(m), **kw)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    tops.sgd_mom_update(tw, torch.from_numpy(g), tm, **kw)
    np.testing.assert_allclose(tw.numpy(), np.asarray(want_w), **OPT_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(want_m), **OPT_TOL)


@pytest.mark.parametrize("clip", [-1.0, 0.05])
def test_adam_update_matches_jax(clip):
    w, g, m = _opt_inputs(40)
    v = np.abs(_normal((4, 6), 43))
    kw = dict(lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=1e-3,
              rescale_grad=0.25, clip_gradient=clip)
    want = jops.adam_update(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m),
                            jnp.asarray(v), **kw)
    tw, tm, tv = (torch.from_numpy(a.copy()) for a in (w, m, v))
    tops.adam_update(tw, torch.from_numpy(g), tm, tv, **kw)
    for got, w_ in zip((tw, tm, tv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), **OPT_TOL)


def test_update_ops_work_on_parameters_that_require_grad():
    w = torch.nn.Parameter(torch.ones(3))
    tops.sgd_update(w, torch.ones(3), lr=0.5)
    assert torch.equal(w.detach(), torch.full((3,), 0.5))


def test_dropout_law_in_train_mode():
    """Keep rate 1-p, kept values scaled by 1/(1-p), the same mask for
    the same seed, the identity in predict mode and outside record."""
    p = 0.3
    drop = Dropout(p, device="cpu")
    x = torch.ones(200, 500)
    trandom.seed(123)
    with autograd.record():
        a = drop(x)
    kept = a != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / (1 - p)))
    trandom.seed(123)
    with autograd.train_mode():
        b = drop(x)
    assert torch.equal(a, b)
    with autograd.record(), autograd.predict_mode():
        assert torch.equal(drop(x), x)
    assert torch.equal(drop(x), x)


def test_dropout_gradient_is_the_scaled_mask():
    trandom.seed(5)
    x = torch.randn(4, 64, 8, requires_grad=True)
    out = tnn.dropout(x, p=0.5, training=True)
    (grad,) = torch.autograd.grad(out.sum(), x)
    torch.testing.assert_close(grad, (out != 0).float() * 2.0)


def test_generators_are_per_device_and_leave_torch_global_rng_alone():
    torch.manual_seed(0)
    before = torch.get_rng_state()
    trandom.seed(7)
    g = trandom.generator("cpu")
    assert g is trandom.generator(torch.device("cpu"))
    tnn.dropout(torch.ones(10, 10), p=0.5, training=True)
    assert torch.equal(torch.get_rng_state(), before)
