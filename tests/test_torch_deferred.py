"""Deferred input widths in the port against the JAX package, on the CPU.

A width of 0 (``Dense(units)``, ``Conv2D(..., in_channels=0)``,
``BatchNorm()``, ``LayerNorm()``, ``LSTM(hidden)``) makes a
``DeferredParameter`` that the layer materializes in place at its first
input.  Each layer, initialised and run once in both packages, takes the
JAX layer's shapes; with the JAX weights carried over, the outputs agree
within 1e-5 and the parameter gradients within 1e-4 (absolute, scaled by
the largest magnitude when it exceeds 1).  Beside them: a Trainer built
before the first forward (SGD with momentum, 3 steps within 1e-5 of the
JAX trajectory), ``hybridize()`` before the first call (the eager pass
that finishes the shapes draws no dropout and moves no running
statistic), ``save_parameters`` before materialization raising, and what
``initialize`` does before the shapes are known.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgl
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.block import DeferredParameter, Parameter

CASES = {
    "dense": (lambda m, kw: m.nn.Dense(5, **kw), (2, 3, 4)),
    "dense-no-flatten": (lambda m, kw: m.nn.Dense(5, flatten=False, **kw),
                         (2, 3, 4)),
    "conv2d": (lambda m, kw: m.nn.Conv2D(4, 3, padding=1, layout="NHWC",
                                         **kw), (2, 6, 6, 3)),
    "batchnorm": (lambda m, kw: m.nn.BatchNorm(axis=-1, **kw),
                  (2, 4, 5, 3)),
    "layernorm": (lambda m, kw: m.nn.LayerNorm(**kw), (2, 3, 7)),
    "lstm": (lambda m, kw: m.rnn.LSTM(6, 2, **kw), (5, 3, 4)),
}


def _close(got, want, tol, what=""):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_deferred_layer_matches_jax(case):
    make, shape = CASES[case]
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    mx.random.seed(1)
    jl = make(jgl, {})
    jl.initialize(mx.init.Uniform(0.3))
    jl(mx.nd.array(x))
    tl = make(gluon, {"device": "cpu"})
    deferred = [k for k, p in tl.collect_params().items()
                if isinstance(p, DeferredParameter)]
    assert deferred  # the width waits for the input
    held = {k: p for k, p in tl.collect_params().items()}
    tl.initialize()
    tl(torch.from_numpy(x))  # materializes
    params = {k: p.data().asnumpy()
              for k, p in jl._collect_params_with_prefix().items()}
    assert {k: tuple(p.shape) for k, p in tl.collect_params().items()} \
        == {k: v.shape for k, v in params.items()}
    assert all(tl.collect_params()[k] is held[k] for k in held)
    assert all(type(p) is Parameter for p in tl.collect_params().values())
    load_mxnet_tpu_params(tl, params)
    with jag.record():
        jout = jl(mx.nd.array(x))
        jloss = (jout * jout).sum()
    jloss.backward()
    with autograd.record():
        tout = tl(torch.from_numpy(x))
        tloss = (tout * tout).sum()
    autograd.backward(tloss)
    _close(tout.detach().numpy(), jout.asnumpy(), 1e-5, "output")
    for k, p in jl._collect_params_with_prefix().items():
        if p.grad_req != "null":
            _close(tl.collect_params()[k].grad.numpy(), p.grad().asnumpy(),
                   1e-4, k)


def _mlp(pkg, **kw):
    net = pkg.nn.HybridSequential(**kw)
    net.add(pkg.nn.Dense(8, activation="relu", **kw),
            pkg.nn.Dense(3, **kw))
    return net


def test_trainer_built_before_the_first_forward():
    """The Trainer holds the deferred parameters; the optimizer's state
    is made at the first step; 3 SGD-momentum steps follow the JAX
    package's within 1e-5."""
    rng = np.random.RandomState(0)
    x, y = rng.randn(4, 5).astype(np.float32), rng.randn(4, 3) \
        .astype(np.float32)
    mx.random.seed(0)
    jnet = _mlp(jgl)
    jnet.initialize()
    jtr = jgl.Trainer(jnet.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9})
    jnet(mx.nd.array(x))
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net = _mlp(gluon, device="cpu")
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    assert all(isinstance(p, DeferredParameter)
               for k, p in net.collect_params().items() if "weight" in k)
    net(torch.from_numpy(x))
    load_mxnet_tpu_params(net, params)
    assert trainer._updaters[0].states == {}
    for _ in range(3):
        with jag.record():
            jl = ((jnet(mx.nd.array(x)) - mx.nd.array(y)) ** 2).sum()
        jl.backward()
        jtr.step(4)
        with autograd.record():
            tl = ((net(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2) \
                .sum()
        autograd.backward(tl)
        trainer.step(4)
        np.testing.assert_allclose(float(tl.detach()), float(jl.asnumpy()),
                                   rtol=1e-5)
    assert len(trainer._updaters[0].states) == 4
    for k, p in jnet._collect_params_with_prefix().items():
        _close(net.collect_params()[k].detach().numpy(),
               p.data().asnumpy(), 1e-5, k)


def _bn_net(device="cpu"):
    net = tnn.HybridSequential(device=device)
    net.add(tnn.Dense(6, device=device), tnn.Dropout(0.5, device=device),
            tnn.BatchNorm(device=device))
    return net


def test_hybridize_before_the_first_call():
    """A recorded first call of a block hybridized before it has its
    shapes: the eager pass that finishes them runs in predict mode, so
    the call's dropout mask and running statistics are those of an eager
    twin's first call, once."""
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 4)
                         .astype(np.float32))
    outs, stats = [], []
    for hybrid in (False, True):
        net = _bn_net().initialize(seed=2)
        if hybrid:
            net.hybridize()
        tmx.random.seed(9)
        with autograd.record():
            out = net(x)
        autograd.backward(out.sum())
        outs.append(out.detach())
        bn = getattr(net, "2")
        stats.append((bn.running_mean.detach().clone(),
                      getattr(net, "0").weight.grad.clone()))
        if hybrid:
            assert len(net._cached_graphs) == 1
            assert tuple(getattr(net, "0").weight.shape) == (6, 4)
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*stats):
        assert torch.equal(a, b)
    assert stats[0][0].abs().sum() > 0  # moved once, by the recorded call


def test_save_before_materialization_raises(tmp_path):
    net = _mlp(gluon, device="cpu").initialize()
    with pytest.raises(tmx.MXNetError, match="first input"):
        net.save_parameters(str(tmp_path / "net.params"))
    net(torch.ones(2, 5))
    net.save_parameters(str(tmp_path / "net.params"))
    fresh = _mlp(gluon, device="cpu")
    fresh.load_parameters(str(tmp_path / "net.params"))  # takes the shapes
    assert torch.equal(fresh(torch.ones(2, 5)), net(torch.ones(2, 5)))
    with pytest.raises(tmx.MXNetError):  # a known dimension disagrees
        load_mxnet_tpu_params(tnn.Dense(4, device="cpu"),
                              {"weight": np.zeros((5, 3), np.float32),
                               "bias": np.zeros(4, np.float32)})


def test_train_step_refuses_a_deferred_block():
    """GluonTrainStep keeps copies of the parameters' shapes: it raises
    until a forward has given them, then builds."""
    from mxnet_tpu_torch.parallel import GluonTrainStep

    net = _mlp(gluon, device="cpu").initialize()
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(tmx.MXNetError, match="waits for its shape"):
        GluonTrainStep(net, loss, device="cpu")
    net(torch.ones(2, 5))
    step = GluonTrainStep(net, loss, device="cpu")
    assert float(step(np.ones((2, 5), np.float32),
                      np.zeros(2, np.float32))) > 0


def test_initialize_before_the_shapes_are_known():
    """initialize() records its initializer, drawn at materialization and
    the same for the same seed; a layer never initialized holds zeros;
    grad_req, lr_mult and cast survive materialization."""
    def dense(seed):
        d = tnn.Dense(4, device="cpu").initialize(tmx.init.Uniform(0.5),
                                                  seed=seed)
        d(torch.ones(2, 3))
        return d.weight.detach()

    w = dense(3)
    assert torch.equal(w, dense(3)) and not torch.equal(w, dense(4))
    assert 0 < float(w.abs().max()) <= 0.5
    plain = tnn.Dense(4, device="cpu")
    plain(torch.ones(2, 3))
    assert not plain.weight.detach().any()
    bn = tnn.BatchNorm(center=False, device="cpu").initialize()
    bn.gamma.lr_mult = 0.5
    bn.cast("float64")
    bn(torch.ones(2, 3, dtype=torch.float64))
    assert bn.beta.grad_req == "null" and not bn.beta.requires_grad
    assert bn.running_var.grad_req == "null"
    assert bn.gamma.lr_mult == 0.5 and bn.gamma.dtype == torch.float64
    assert torch.equal(bn.running_var.detach(),
                       torch.ones(3, dtype=torch.float64))
    lstm = trnn.LSTM(5, 2, bidirectional=True, device="cpu").initialize()
    lstm(torch.ones(4, 2, 3))
    assert tuple(lstm.l0_i2h_weight.shape) == (20, 3)
    assert tuple(lstm.r0_i2h_weight.shape) == (20, 3)
    assert tuple(lstm.l1_i2h_weight.shape) == (20, 10)
