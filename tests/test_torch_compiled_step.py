"""``Trainer.compile`` of the port against the JAX package's, on the CPU,
and ``save_states``/``load_states``.

The same 2-layer TransformerLM (vocab 100, units 64, 4 heads, S = 32),
initialised in JAX and carried over, trains on the same fixed (4, 32)
batch through ``trainer.compile(net, SoftmaxCrossEntropyLoss())`` in both
packages, with each compile-safe optimizer, for 3 steps; the JAX
attention runs its plain reference on the CPU, as its own tests run it.
On the port the compiled step (which the CPU runs eagerly under its cache
keys) is also held bit for bit to its own eager record / backward /
``trainer.step`` loop.

Each attention layer's ``qkv.bias`` is held fixed (``grad_req='null'``)
in both packages: its key third has a true gradient of 0 (a softmax does
not see a constant added to a row), whose float32 noise an optimizer
that normalizes the gradient turns into full-rate steps.  For the same
reason Adam, FTML, RMSProp and AdaGrad take an epsilon of 1e-4: at their
default ones (1e-8, 1e-7) an update's derivative in the gradient reaches
``lr / epsilon``, so the packages' last-bit differences in a gradient
near 0 move a weight by about 1e-5 and the comparison would measure that.
Adamax's 1e-8 is fixed in its op; it takes a weight decay instead, which
moves its gradients off 0.

Tolerances: each step's per-sample losses within 1e-5 relative; every
parameter within 1e-5 of its largest magnitude (Adamax, whose update
divides by a running maximum of |g|, 1e-4; measured 5.3e-5); float16
with ``multi_precision``, the losses and the float32 masters within 2e-3
of their largest magnitude, except the masters of the parameters that
start at 0 (biases, LayerNorm betas: they hold only the three steps of
about lr each), 2e-2: their float16 gradients are sums over the batch's
128 positions whose relative error reaches 1e-2 where the terms cancel
(measured: the losses 8.5e-4, the masters 5.0e-4, those of the
parameters that start at 0 9.1e-3).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import gluon as jgl
from mxnet_tpu import runtime_stats as jrts
from mxnet_tpu.gluon.nn.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch import (MXNetError, autograd, checkpoint, compiled_step,
                             gluon, lr_scheduler, runtime_stats)
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.nn import Dense, TransformerLM

V, U, L, H, S, B = 100, 64, 2, 4, 32, 4
STEPS = 3
OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "nag": {"learning_rate": 0.1, "momentum": 0.9},
    "signum": {},
    "adam": {"epsilon": 1e-4},
    "adamax": {"wd": 1e-3},
    "ftml": {"epsilon": 1e-4},
    "ftrl": {},
    "rmsprop": {"epsilon": 1e-4},
    "rmsprop/centered": {"centered": True, "epsilon": 1e-4},
    "adagrad": {"eps": 1e-4},
    "adadelta": {},
}
PARAM_TOL = {"adamax": 1e-4}


@pytest.fixture(scope="module")
def setup():
    mx.random.seed(7)
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, size=(B, S)).astype(np.float32)
    y = rng.randint(0, V, size=(B, S)).astype(np.float32)
    net = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S)
    net.initialize()
    net(mx.nd.array(x))
    params = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    return x, y, params


def _frozen(name):
    return name.endswith("attn.qkv.bias")


def _jax_net(params, x, dtype=None):
    net = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S)
    net.initialize()
    net(mx.nd.array(x))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
        if _frozen(k):
            p.grad_req = "null"
    if dtype is not None:
        net.cast(dtype)
    return net


def _port_net(params, dtype=None):
    net = load_mxnet_tpu_params(
        TransformerLM(V, units=U, num_layers=L, num_heads=H, max_length=S,
                      device="cpu"), params)
    for k, p in net.collect_params().items():
        if _frozen(k):
            p.grad_req = "null"
    if dtype is not None:
        net.cast(dtype)
    return net


def _opt(case):
    return case.split("/")[0], dict(OPTIMIZERS[case])


def _jax_run(params, x, y, name, kw, dtype=None, steps=STEPS):
    net = _jax_net(params, x, dtype)
    cs = jgl.Trainer(net.collect_params(), name, kw).compile(
        net, jgl.loss.SoftmaxCrossEntropyLoss())
    losses = [cs.step(mx.nd.array(x), mx.nd.array(y)).asnumpy()
              .astype(np.float32) for _ in range(steps)]
    return losses, {k: p.data().asnumpy().astype(np.float32)
                    for k, p in net._collect_params_with_prefix().items()}


def _port_compiled(params, x, y, name, kw, dtype=None, steps=STEPS):
    net = _port_net(params, dtype)
    trainer = gluon.Trainer(net.collect_params(), name, kw)
    cs = trainer.compile(net, gluon.loss.SoftmaxCrossEntropyLoss())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = [cs.step(xt, yt) for _ in range(steps)]
    return net, trainer, cs, losses


def _state(net, trainer):
    from mxnet_tpu_torch.parallel.gluon_step import _leaves

    out = [p.detach().clone() for p in net.parameters()]
    for st in trainer._updaters[0].states.values():
        out += [t.clone() for t in _leaves(st)]
    return out


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_compiled_step_matches_jax(setup, case):
    x, y, params = setup
    name, kw = _opt(case)
    want_losses, want = _jax_run(params, x, y, name, dict(kw))
    net, _, cs, losses = _port_compiled(params, x, y, name, dict(kw))
    for got, ref in zip(losses, want_losses):
        assert got.shape == (B,)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    tol = PARAM_TOL.get(name, 1e-5)
    moved = 0.0
    for k, p in net.collect_params().items():
        scale = max(np.abs(want[k]).max(), 1e-30)
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                   atol=tol * scale, err_msg=k)
        moved = max(moved, np.abs(want[k] - params[k]).max() / scale)
    assert moved > 1e-3
    assert len(cs.graphs) == 1


def test_float16_multi_precision_adam_matches_jax(setup):
    x, y, params = setup
    kw = {"learning_rate": 1e-3, "epsilon": 1e-4, "multi_precision": True}
    want_losses, want = _jax_run(params, x, y, "adam", dict(kw), "float16")
    net, trainer, _, losses = _port_compiled(params, x, y, "adam", dict(kw),
                                             "float16")
    for got, ref in zip(losses, want_losses):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max())
    assert want_losses[-1].mean() < want_losses[0].mean()
    states = trainer._updaters[0].states
    for i, (k, p) in enumerate(net.collect_params().items()):
        assert p.dtype == torch.float16
        if p.grad_req == "null":
            continue
        master = states[i][0]
        assert master.dtype == torch.float32
        assert torch.equal(p.detach(), master.half())
        # a parameter that starts at 0 holds only the steps taken
        tol = 2e-2 if not params[k].any() else 2e-3
        np.testing.assert_allclose(master.numpy(), want[k], rtol=0,
                                   atol=tol * np.abs(want[k]).max(),
                                   err_msg=k)


def _eager_loop(net, trainer, x, y, steps=STEPS):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    out = []
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(xt), yt)
        autograd.backward(loss)
        trainer.step(B)
        out.append(loss.detach())
    return out


@pytest.mark.parametrize("case", sorted(OPTIMIZERS) + ["adam/float16"])
def test_compiled_step_is_its_eager_loop_bitwise(setup, case):
    """The compiled step against record / backward / trainer.step from
    the same state, under a FactorScheduler: the same bits, and one cache
    entry however the rate moves."""
    x, y, params = setup
    name = case.split("/")[0]
    dtype = "float16" if case.endswith("float16") else None
    kw = dict(OPTIMIZERS.get(case, {}), multi_precision=dtype is not None)

    def opt_kw():
        return dict(kw, lr_scheduler=lr_scheduler.FactorScheduler(
            step=1, factor=0.5))

    net, trainer, cs, losses = _port_compiled(params, x, y, name, opt_kw(),
                                              dtype)
    net2 = _port_net(params, dtype)
    trainer2 = gluon.Trainer(net2.collect_params(), name, opt_kw())
    want = _eager_loop(net2, trainer2, x, y)
    assert all(torch.equal(a, b) for a, b in zip(losses, want))
    assert all(torch.equal(a, b) for a, b in zip(_state(net, trainer),
                                                 _state(net2, trainer2)))
    assert trainer.learning_rate == trainer2.learning_rate
    assert len(cs.graphs) == 1
    (entry,) = cs.graphs.values()
    assert entry.replays == STEPS


@pytest.mark.parametrize("name", ["nadam", "lbsgd", "dcasgd", "sgld",
                                  "test"])
def test_optimizers_that_are_not_compile_safe_raise(name):
    net = Dense(3, in_units=4, device="cpu").initialize()
    trainer = gluon.Trainer(net.collect_params(), name)
    with pytest.raises(MXNetError, match="not compiled-step safe"):
        trainer.compile(net, gluon.loss.L2Loss())


def test_zero_and_unmanaged_parameters_raise(monkeypatch):
    net = Dense(3, in_units=4, device="cpu").initialize()
    other = Dense(3, in_units=4, device="cpu").initialize()
    loss = gluon.loss.L2Loss()
    trainer = gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(MXNetError, match="item 9"):
        trainer.compile(net, loss, zero=True)
    monkeypatch.setenv("MXNET_TPU_ZERO", "1")
    with pytest.raises(MXNetError, match="item 9"):
        trainer.compile(net, loss)
    monkeypatch.delenv("MXNET_TPU_ZERO")
    # a Trainer parameter outside the block would stop updating
    both = gluon.Trainer(list(net.parameters()) + list(other.parameters()),
                         "sgd")
    with pytest.raises(MXNetError, match="not part of this block"):
        both.compile(net, loss)
    # a trainable of the block that the Trainer does not manage
    with pytest.raises(MXNetError, match="not managed by this Trainer"):
        gluon.Trainer(net.collect_params(), "sgd").compile(
            _pair(net, other), loss)


def _pair(a, b):
    seq = gluon.nn.HybridSequential(device="cpu")
    seq.add(a)
    seq.add(b)
    return seq


def _dense_step(trainer_kw=None):
    net = Dense(3, in_units=4, device="cpu").initialize(seed=1)
    trainer = gluon.Trainer(net.collect_params(), "adam", trainer_kw or {})
    cs = trainer.compile(net, gluon.loss.L2Loss())
    return net, trainer, cs


def test_cast_and_load_states_drop_the_entries(tmp_path):
    net, trainer, cs = _dense_step()
    x, y = torch.ones(2, 4), torch.zeros(2, 3)
    cs.step(x, y)
    assert len(cs.graphs) == 1
    cs.step(torch.ones(3, 4), torch.zeros(3, 3))  # a new signature
    assert len(cs.graphs) == 2
    path = str(tmp_path / "t.states")
    trainer.save_states(path)
    trainer.load_states(path)
    cs.step(x, y)
    assert len(cs.graphs) == 1  # new state tensors: new entries
    net.cast("float64")
    cs.step(x.double(), y.double())
    assert list(cs.graphs)[0][1] == torch.float64


@pytest.mark.parametrize("compiled", [True, False])
def test_resume_from_save_states_is_bitwise(setup, tmp_path, compiled):
    """Four Adam steps, and two steps, save_states, a new net and Trainer
    loaded from them, two more: the same bits."""
    x, y, params = setup
    kw = {"learning_rate": 1e-3, "multi_precision": True}
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def stepper(net, trainer):
        if compiled:
            cs = trainer.compile(net, gluon.loss.SoftmaxCrossEntropyLoss())
            return lambda: cs.step(xt, yt)
        return lambda: _eager_loop(net, trainer, x, y, 1)[0]

    net = _port_net(params, "float16")
    trainer = gluon.Trainer(net.collect_params(), "adam", dict(kw))
    step = stepper(net, trainer)
    want = [step() for _ in range(4)]

    net = _port_net(params, "float16")
    trainer = gluon.Trainer(net.collect_params(), "adam", dict(kw))
    step = stepper(net, trainer)
    got = [step() for _ in range(2)]
    path = str(tmp_path / "lm.states")
    trainer.save_states(path)
    weights = {k: v.clone() for k, v in net.state_dict().items()}
    net2 = _port_net(params, "float16")
    net2.load_state_dict(weights)
    trainer2 = gluon.Trainer(net2.collect_params(), "adam", dict(kw))
    trainer2.load_states(path)
    step = stepper(net2, trainer2)
    got += [step() for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trainer2.optimizer._index_update_count == {
        i: 4 for i in trainer2.optimizer._index_update_count}


def test_states_file_header_legacy_and_version(tmp_path):
    net, trainer, cs = _dense_step({"learning_rate": 0.01})
    cs.step(torch.ones(2, 4), torch.zeros(2, 3))
    path = str(tmp_path / "t.states")
    trainer.save_states(path)
    assert not [n for n in os.listdir(str(tmp_path)) if ".tmp" in n]
    data = open(path, "rb").read()
    magic = jckpt.TRAINER_STATES_MAGIC
    assert checkpoint.TRAINER_STATES_MAGIC == magic
    assert checkpoint.TRAINER_STATES_VERSION == jckpt.TRAINER_STATES_VERSION
    assert data[:len(magic)] == magic
    assert data[len(magic)] == jckpt.TRAINER_STATES_VERSION
    assert data[len(magic) + 1:len(magic) + 2] == b"\n"
    payload = data[len(magic) + 2:]
    counts = trainer.optimizer._index_update_count
    # legacy: the JAX package's (a pickle of the bytes) and MXNet's (the
    # bytes themselves)
    for i, blob in enumerate((pickle.dumps(payload), payload)):
        legacy = str(tmp_path / ("legacy%d" % i))
        with open(legacy, "wb") as f:
            f.write(blob)
        _, other, _ = _dense_step()
        other.load_states(legacy)
        assert other.optimizer._index_update_count == counts
    newer = str(tmp_path / "v2")
    with open(newer, "wb") as f:
        f.write(magic + bytes([2]) + b"\n" + payload)
    with pytest.raises(ValueError, match="version 2"):
        trainer.load_states(newer)


def test_load_states_adopts_the_loaded_optimizer(tmp_path):
    """MXNet's Trainer takes the loaded optimizer (with its parameters and
    schedule); the JAX package's keeps the old one while its Updaters take
    the loaded one (ROADMAP "Faults of the reference")."""
    jnet = jgl.nn.Dense(3, in_units=4)
    jnet.initialize()
    jtr = jgl.Trainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1})
    jpath = str(tmp_path / "j.states")
    jtr.save_states(jpath)
    jtr.load_states(jpath)
    assert jtr._optimizer is not jtr._updaters[0].optimizer

    sched = lr_scheduler.FactorScheduler(step=1, factor=0.5)
    net, trainer, _ = _dense_step({"learning_rate": 0.1,
                                   "lr_scheduler": sched})
    path = str(tmp_path / "t.states")
    trainer.save_states(path)
    old = trainer.optimizer
    trainer.load_states(path)
    assert trainer.optimizer is trainer._updaters[0].optimizer
    assert trainer.optimizer is not old
    assert trainer.optimizer.param_dict[0] is net.weight
    assert trainer.optimizer.lr_scheduler is sched


def test_step_counters_match_jax():
    jrts.reset()
    runtime_stats.reset()
    mx.random.seed(3)
    jnet = jgl.nn.Dense(3, in_units=4)
    jnet.initialize()
    jcs = jgl.Trainer(jnet.collect_params(), "sgd").compile(
        jnet, jgl.loss.L2Loss())
    net, _, cs = _dense_step()
    for _ in range(3):
        jcs.step(mx.nd.ones((2, 4)), mx.nd.zeros((2, 3)))
        cs.step(torch.ones(2, 4), torch.zeros(2, 3))
    for name in ("trainer_steps", "compiled_step_steps"):
        assert runtime_stats.snapshot()["counters"][name] == 3 == \
            jrts.snapshot()["counters"][name]
    assert compiled_step.donation_active()
    assert compiled_step.env_enabled() is (
        os.environ.get("MXNET_TPU_COMPILED_STEP") == "1")


def test_deferred_widths_are_finished_by_the_first_step():
    """A block whose widths wait for its input: the first step runs one
    forward to finish them (as the JAX package's build does), then steps
    as the eager loop."""
    def make():
        net = gluon.nn.HybridSequential(device="cpu")
        net.add(Dense(8, activation="relu", device="cpu"))
        net.add(Dense(3, device="cpu"))
        return net.initialize(seed=5)

    x = torch.from_numpy(np.random.RandomState(1).randn(4, 6)
                         .astype(np.float32))
    y = torch.zeros(4, 3)
    net, net2 = make(), make()
    cs = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1}).compile(net,
                                                       gluon.loss.L2Loss())
    assert cs.trainable is None
    got = [cs.step(x, y) for _ in range(2)]
    trainer2 = gluon.Trainer(net2.collect_params(), "sgd",
                             {"learning_rate": 0.1})
    want = []
    for _ in range(2):
        with autograd.record():
            loss = gluon.loss.L2Loss()(net2(x), y)
        autograd.backward(loss)
        trainer2.step(4)
        want.append(loss.detach())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                 net2.parameters()))
