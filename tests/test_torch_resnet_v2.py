"""The port's ResNet v2 family, the space-to-depth stem and the rest of
GluonTrainStep's signature (optimizer=, aux_loss_weight, the sharding and
ZeRO arguments) against the JAX package, on the CPU.

The JAX zoo's parameters cross through load_mxnet_tpu_params.

Tolerances:
- logits, of their largest magnitude: 1e-5 in predict mode, 1e-4 in train
  mode, as tests/test_torch_resnet.py holds v1 (BatchNorm's division by
  the spread of two samples at the deepest stages magnifies the float32
  differences of each package's sums);
- every parameter gradient of ``sum(out^2)``, of its largest magnitude:
  1e-4 in predict mode, 1e-3 in train mode (as there); a tensor's scale
  is at least 1e-3 of the net's largest gradient, for the gradients whose
  true value is 0: in train mode the stem BatchNorm's gamma and beta feed
  only the next block's BatchNorm (through relu and the max pool, which
  keep a positive scale), so their gradients are rounding noise of about
  1e-7 (measured: 3e-9 apart between the packages);
- the space-to-depth stem against the JAX stem and against the 7x7/s2
  stem on the same weight: 1e-5 (the same products, summed in another
  order);
- GluonTrainStep(optimizer=...) from the JAX step's state before each
  step, float32: the loss within 1e-5 relative; the weights and running
  statistics within 1e-3 of each tensor's largest magnitude (at least
  1e-3), the optimizer states within 1e-3 of their largest (at least
  1e-3 of the step's largest), as tests/test_torch_gluon_step.py holds
  the fused step: a relative perturbation of 1e-7 grows through batch
  statistics over four samples.  The stem BatchNorm's gamma and beta are
  held fixed in both packages: in train mode they feed only the next
  block's BatchNorm, so their true gradient is 0 and its rounding noise,
  which Adam scales to a step of the full rate (measured: beta 2.3e-2
  apart after one step), says nothing of either package;
- a two-layer MLP under a FactorScheduler, free-running for 5 steps:
  every weight within 1e-5 of the JAX trajectory's largest magnitude,
  and bitwise equal to the port's own eager Updater loop (the same
  float32 operations, the rate read from the buffer instead of a Python
  float);
- aux_loss_weight, 2 steps of a dense block: the loss within 1e-6 and the
  weights within 1e-6 of the JAX step's.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgl
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision.resnet import _S2DStem as JS2DStem
from mxnet_tpu.parallel.gluon_step import GluonTrainStep as JStep
from mxnet_tpu.parallel.mesh import create_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.block import HybridBlock
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import _S2DStem
from mxnet_tpu_torch.parallel import GluonTrainStep

GRAD_FLOOR = 1e-3


def _jax_net(make, shape, seed=0):
    mx.random.seed(seed)
    net = make()
    net.initialize()
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    out = net(mx.nd.array(x)).asnumpy()
    params = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    return net, params, x, out


def _close(got, want, tol=1e-5):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def _grads_of(jnet, net, x, train):
    """Outputs and gradients of ``sum(out^2)`` in both packages, recorded
    in train mode (batch statistics) or predict mode (running ones)."""
    xj = mx.nd.array(x)
    with jag.record(train_mode=train):
        jout = jnet(xj)
        (jout * jout).sum().backward()
    with tag.record(train_mode=train):
        tout = net(torch.from_numpy(x))
    tag.backward((tout * tout).sum())
    jg = {k: p.grad().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()
          if p.grad_req != "null"}
    tg = {k: p.grad.numpy()
          for k, p in net._collect_params_with_prefix().items()
          if p.requires_grad and p.grad is not None}
    return tout.detach().numpy(), jout.asnumpy(), tg, jg


NETS = {
    "resnet18_v2": (lambda v, **kw: v.resnet18_v2(classes=6, **kw), 64),
    "bottleneck-v2-one-stage": (
        lambda v, **kw: v.ResNetV2(v.BottleneckV2, [1], [8, 32], classes=4,
                                   **kw), 16),
}


@pytest.mark.parametrize("case", sorted(NETS))
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("train", [False, True], ids=["predict", "train"])
def test_v2_outputs_and_gradients_match_jax(case, layout, train):
    make, size = NETS[case]
    shape = (2, size, size, 3) if layout == "NHWC" else (2, 3, size, size)
    jnet, params, x, want = _jax_net(
        lambda: make(jvision, layout=layout), shape)
    net = make(tvision, layout=layout, device="cpu")
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: v.shape for k, v in params.items()}
    load_mxnet_tpu_params(net, params)
    with torch.no_grad():
        _close(net(torch.from_numpy(x)).numpy(), want)
    got, jout, tg, jg = _grads_of(jnet, net, x, train)
    _close(got, jout, 1e-4 if train else 1e-5)
    # the raw input's BatchNorm (scale=False, center=False) trains nothing
    assert set(tg) == set(jg) and not any(k.startswith("features.0.")
                                          for k in tg)
    tol = 1e-3 if train else 1e-4
    big = max(float(np.abs(g).max()) for g in jg.values())
    for k, want_g in jg.items():
        assert tg[k].shape == want_g.shape, k
        assert float(np.abs(tg[k] - want_g).max()) \
            <= tol * max(float(np.abs(want_g).max()), GRAD_FLOOR * big), k


def test_v2_names_and_entry_points():
    net = tvision.resnet50_v2(layout="NHWC", device="meta")
    names = set(net.state_dict())
    for name in ("features.0.running_var", "features.5.0.bn1.gamma",
                 "features.5.0.conv1.weight", "features.5.0.downsample.weight",
                 "features.8.2.bn3.beta", "features.9.gamma",
                 "output.weight"):
        assert name in names, name
    assert "features.5.0.conv1.bias" not in names
    assert isinstance(tvision.get_resnet(2, 34, device="meta"),
                      tvision.ResNetV2)
    for depth in (18, 34, 50, 101, 152):
        getattr(tvision, "resnet%d_v2" % depth)
    with pytest.raises(ValueError, match="1 or 2"):
        tvision.get_resnet(3, 50, device="meta")


# ------------------------------------------------- the space-to-depth stem

def test_s2d_stem_matches_jax_and_the_standard_stem():
    rng = np.random.RandomState(1)
    x = rng.rand(2, 16, 18, 3).astype(np.float32)
    mx.random.seed(2)
    jstem = JS2DStem(8, prefix="conv0_")
    jstem.initialize()
    jstem(mx.nd.array(x))
    w = jstem.weight.data().asnumpy()
    assert w.shape == (8, 7, 7, 3)
    stem = _S2DStem(8, device="cpu")
    conv = tvision.resnet.Conv2D(8, 7, 2, 3, use_bias=False, in_channels=3,
                                 layout="NHWC", device="cpu")
    with torch.no_grad():
        stem._parameters["weight"].copy_(torch.from_numpy(w))
        conv._parameters["weight"].copy_(torch.from_numpy(w))
    xj = mx.nd.array(x)
    with jag.record():
        jout = jstem(xj)
        (jout * jout).sum().backward()
    outs, grads = [], []
    for layer in (stem, conv):
        with tag.record():
            out = layer(torch.from_numpy(x))
        tag.backward((out * out).sum())
        outs.append(out.detach().numpy())
        grads.append(layer._parameters["weight"].grad.numpy())
    assert outs[0].shape == (2, 8, 9, 8)
    _close(outs[0], jout.asnumpy())
    _close(outs[0], outs[1])
    _close(grads[0], jstem.weight.grad().asnumpy())
    _close(grads[0], grads[1])


def test_s2d_resnet_loads_the_standard_stems_checkpoint():
    make = (lambda v, **kw: v.ResNetV1(v.BottleneckV1, [1], [8, 32],
                                       classes=4, layout="NHWC", **kw))
    _, params, x, want = _jax_net(lambda: make(jvision), (2, 16, 16, 3))
    net = load_mxnet_tpu_params(make(tvision, stem_s2d=True, device="cpu"),
                                params)
    assert isinstance(net.features[0], _S2DStem)
    with torch.no_grad():
        _close(net(torch.from_numpy(x)).numpy(), want)


def test_s2d_stem_refusals():
    with pytest.raises(ValueError, match="NHWC"):
        tvision.resnet50_v1(stem_s2d=True, device="meta")
    with pytest.raises(ValueError, match="thumbnail"):
        tvision.ResNetV1(tvision.BasicBlockV1, [1], [8, 8], thumbnail=True,
                         layout="NHWC", stem_s2d=True, device="meta")
    stem = _S2DStem(4, device="cpu")
    with pytest.raises(ValueError, match="even"):
        stem(torch.zeros(1, 15, 16, 3))


# ---------------------------------------- GluonTrainStep(optimizer=...)

SMALL = (lambda v, **kw: v.ResNetV2(v.BottleneckV2, [1, 1], [8, 16, 32],
                                    classes=5, layout="NHWC", **kw))
OPTIMIZERS = {
    "sgd": dict(name="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4),
    "adam": dict(name="adam", learning_rate=0.01, wd=1e-4),
}


def _mesh():
    return create_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])


def _batch():
    rng = np.random.RandomState(0)
    return (rng.rand(4, 16, 16, 3).astype(np.float32),
            rng.randint(0, 5, (4,)).astype(np.int32))


def _optimizer(pkg, kind, begin=0):
    kw = dict(OPTIMIZERS[kind])
    return pkg.optimizer.create(kw.pop("name"), begin_num_update=begin, **kw)


def _hold_stem_bn(net):
    """The stem BatchNorm's gamma and beta out of training."""
    net.features[2].gamma.grad_req = "null"
    net.features[2].beta.grad_req = "null"
    return net


def _run_jax_with_optimizer(kind, x, y, steps):
    """The JAX step's states before each step and after the last: (values
    by name, optimizer leaves by name), and the losses."""
    mx.random.seed(3)
    net = SMALL(jvision)
    net.initialize()
    net(mx.nd.zeros((1, 16, 16, 3)))
    _hold_stem_bn(net)
    step = JStep(net, jgl.loss.SoftmaxCrossEntropyLoss(), mesh=_mesh(),
                 optimizer=_optimizer(mx, kind))
    names = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    train = [names[id(p)] for p in step.trainable]
    aux = [names[id(p)] for p in step.aux]
    per = len(step.opt_state) // len(train)

    def state():
        vals = dict(zip(train + aux, (np.asarray(v) for v in
                                      step.train_vals + step.aux_vals)))
        leaves = [np.asarray(s) for s in step.opt_state]
        return vals, {n: leaves[per * i:per * (i + 1)]
                      for i, n in enumerate(train)}

    xs, ys = step.put_batch(x, y)
    states, losses = [state()], []
    for _ in range(steps):
        losses.append(float(np.asarray(step(xs, ys))))
        states.append(state())
    return states, losses


def _port_from(kind, state, k, x, y):
    vals, leaves = state
    net = _hold_stem_bn(load_mxnet_tpu_params(SMALL(tvision, device="cpu"),
                                              vals))
    step = GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer=_optimizer(tmx, kind, begin=k),
                          device="cpu")
    with torch.no_grad():
        for name, st in zip(step._names, step._states):
            st = st if isinstance(st, tuple) else (st,)
            for t, v in zip(st, leaves[name]):
                t.copy_(torch.from_numpy(v))
    loss = float(step(x, y))
    out = {n: [t.numpy().copy() for t in (st if isinstance(st, tuple)
                                          else (st,))]
           for n, st in zip(step._names, step._states)}
    return loss, {k: v.detach().numpy() for k, v in
                  net.state_dict().items()}, out


def _worst(got, want, floor):
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k] - w).max())
               / max(float(np.abs(w).max()), floor) for k, w in want.items())


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(kind):
    x, y = _batch()
    states, losses = _run_jax_with_optimizer(kind, x, y, 3)
    for k in range(3):
        loss, vals, leaves = _port_from(kind, states[k], k, x, y)
        want_vals, want_leaves = states[k + 1]
        assert abs(loss - losses[k]) <= 1e-5 * abs(losses[k]), k
        assert _worst(vals, want_vals, 1e-3) < 1e-3, k
        for j in range(len(next(iter(want_leaves.values())))):
            got = {n: v[j] for n, v in leaves.items()}
            want = {n: v[j] for n, v in want_leaves.items()}
            big = max(float(np.abs(v).max()) for v in want.values())
            assert _worst(got, want, 1e-3 * big) < 1e-3, (k, j)


class _MLP:
    """Dense(16, relu) -> Dense(5) in either package."""

    @staticmethod
    def make(pkg, **kw):
        net = pkg.gluon.nn.HybridSequential(**kw)
        net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=6, **kw))
        net.add(pkg.gluon.nn.Dense(5, in_units=16, **kw))
        return net


def _sched_sgd(pkg):
    return pkg.optimizer.SGD(
        learning_rate=0.5, momentum=0.9, wd=1e-3,
        lr_scheduler=pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5))


def test_factor_scheduler_changes_the_rate_without_a_new_program():
    """The rate halves every 2 steps.  The step's buffer holds each
    step's rate; the step's trajectory equals the port's eager Updater
    loop bit for bit and the JAX step's within 1e-5; one program for all
    five steps (on the CPU, one entry of the step's graph cache is not
    made: the step runs eagerly; on the card chip_smoke.py checks one
    capture)."""
    rng = np.random.RandomState(9)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 5, (8,)).astype(np.int32)
    mx.random.seed(4)
    jnet = _MLP.make(mx)
    jnet.initialize()
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    jstep = JStep(jnet, jgl.loss.SoftmaxCrossEntropyLoss(), mesh=_mesh(),
                  optimizer=_sched_sgd(mx))
    names = {id(p): k for k, p in jnet._collect_params_with_prefix().items()}
    jtrain = [names[id(p)] for p in jstep.trainable]
    xs, ys = jstep.put_batch(x, y)

    net = load_mxnet_tpu_params(_MLP.make(tmx, device="cpu"), params)
    step = GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer=_sched_sgd(tmx), device="cpu")
    eager = load_mxnet_tpu_params(_MLP.make(tmx, device="cpu"), params)
    updater = tmx.optimizer.get_updater(_sched_sgd(tmx))
    eager_params = list(eager._collect_params_with_prefix().values())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rates = []
    for _ in range(5):
        jstep(xs, ys)
        step(x, y)
        rates.append(float(step._scalars[0]))
        with tag.record():
            loss = loss_fn(eager(torch.from_numpy(x)),
                           torch.from_numpy(y)).mean()
        tag.backward(loss)
        for i, p in enumerate(eager_params):
            updater(i, p.grad, p)
        want = dict(zip(jtrain, (np.asarray(v) for v in jstep.train_vals)))
        got = {k: v.detach().numpy() for k, v in net.state_dict().items()}
        for k, w in want.items():
            _close(got[k], w, 1e-5)
        for k, v in eager.state_dict().items():
            assert torch.equal(net.state_dict()[k], v), k
    assert rates == pytest.approx([0.5, 0.5, 0.25, 0.25, 0.125])
    assert step.graphs == {}


def test_aux_loss_weight_matches_jax():
    class Aux:
        """A dense block publishing the mean square of its output."""

        @staticmethod
        def make(pkg, base, **kw):
            class Block(base):
                def __init__(self):
                    super().__init__(**kw)
                    self.dense = pkg.gluon.nn.Dense(4, in_units=3, **kw)
                    self._last = None

                @property
                def aux_loss(self):
                    return (self._last * self._last).mean()

            return Block

    class JBlock(Aux.make(mx, jgl.HybridBlock)):
        def hybrid_forward(self, F, x):
            self._last = self.dense(x)
            return self._last

    class TBlock(Aux.make(tmx, HybridBlock, device="cpu")):
        def forward(self, x):
            self._last = self.dense(x)
            return self._last

    rng = np.random.RandomState(10)
    x = rng.randn(6, 3).astype(np.float32)
    y = rng.randint(0, 4, (6,)).astype(np.int32)
    mx.random.seed(5)
    jnet = JBlock()
    jnet.initialize()
    jnet(mx.nd.array(x))
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    jstep = JStep(jnet, jgl.loss.SoftmaxCrossEntropyLoss(), mesh=_mesh(),
                  lr=0.1, momentum=0.9, aux_loss_weight=0.3)
    net = load_mxnet_tpu_params(TBlock(), params)
    step = GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), None,
                          0.1, 0.9, aux_loss_weight=0.3, device="cpu")
    plain = GluonTrainStep(load_mxnet_tpu_params(TBlock(), params),
                           gluon.loss.SoftmaxCrossEntropyLoss(), None, 0.1,
                           0.9, device="cpu")
    xs, ys = jstep.put_batch(x, y)
    for _ in range(2):
        want = float(np.asarray(jstep(xs, ys)))
        got = float(step(x, y))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
        assert got > float(plain(x, y))  # the aux loss was added
    jstep.sync_to_params()
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(net.state_dict()[k].numpy(),
                                   p.data().asnumpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="aux_loss"):
        _MLP.make(tmx, device="cpu").collect_aux_losses()


def test_zero_and_sharding_arguments():
    net = load_mxnet_tpu_params(
        SMALL(tvision, device="cpu"),
        {k: v.detach().numpy()
         for k, v in SMALL(tvision, device="cpu").initialize(
             seed=1).state_dict().items()})
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(MXNetError, match="param_spec_fn"):
        GluonTrainStep(net, loss, zero=True, param_spec_fn=lambda n, s: None,
                       device="cpu")
    with pytest.raises(MXNetError, match="multi-GPU"):
        GluonTrainStep(net, loss, zero=True, device="cpu")
    os.environ["MXNET_TPU_ZERO"] = "1"
    try:
        with pytest.raises(MXNetError, match="multi-GPU"):
            GluonTrainStep(net, loss, device="cpu")
        GluonTrainStep(net, loss, zero=False, device="cpu")
    finally:
        del os.environ["MXNET_TPU_ZERO"]
    with pytest.raises(MXNetError, match="compiled-step"):
        GluonTrainStep(net, loss, optimizer=tmx.optimizer.Optimizer(),
                       device="cpu")
    step = GluonTrainStep(net, loss, optimizer=_optimizer(tmx, "sgd"),
                          device="cpu")
    with pytest.raises(MXNetError, match="make_chained"):
        step.make_chained(2)
    # the specs are taken on the one device and change nothing
    x, y = _batch()
    seen = []
    nets = [load_mxnet_tpu_params(SMALL(tvision, device="cpu"),
                                  {k: v.detach().numpy()
                                   for k, v in net.state_dict().items()})
            for _ in range(2)]
    a = GluonTrainStep(nets[0], loss, None, 0.1, 0.9, 1e-4, None,
                       lambda name, shape: seen.append(name), ("dp",),
                       ("dp",), device="cpu")
    b = GluonTrainStep(nets[1], loss, types.SimpleNamespace(devices=["cpu"]),
                       0.1, 0.9, 1e-4, device="cpu")
    assert sorted(seen) == sorted(nets[0].state_dict())
    assert a.data_spec == ("dp",) and a.label_spec == ("dp",)
    assert torch.equal(a(x, y), b(x, y))
    for k, v in nets[0].state_dict().items():
        assert torch.equal(nets[1].state_dict()[k], v), k
