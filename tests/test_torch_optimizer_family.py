"""The port's optimizers and update ops against the JAX package's.

Every optimizer class of ``mxnet_tpu/optimizer/optimizer.py`` (and the
``ccSGD`` alias) trains the same small MLP from the same weights on the
same seeded batches through both packages' ``gluon.Trainer``, with weight
decay, gradient clipping and a FactorScheduler; ``multi_precision`` on a
float16 MLP keeps float32 masters in both (each step's float16 gradients
from the JAX backward fed to both).  The update ops' float32 cases
are in ``test_torch_registry.py``; here the ``mp_*`` ops in float16, and
each op fed its per-step scalars as 0-d tensors (a captured step's way).

Tolerances: each trajectory's parameters within 1e-5 of their largest
magnitude after 5 steps (the two packages' float32 sums run in another
order); the float32 masters within 1e-5, the float16 weights within one
float16 step; the ``mp_*`` ops' float16 weights within two float16 steps
and their float32 outputs within 1e-6 of the largest magnitude; a fed
scalar gives the float's bits exactly.
"""

import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgl
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import autograd, gluon, lr_scheduler, optimizer
from mxnet_tpu_torch import test_utils as T
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import registry as treg

STEPS, BATCH = 5, 6
COMMON = {"wd": 1e-3, "clip_gradient": 0.5}
# the hyperparameters each optimizer trains with, beyond COMMON and a
# FactorScheduler halving the rate every 2 updates
OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9},
    "ccsgd": {"learning_rate": 0.1},
    "nag": {"learning_rate": 0.1, "momentum": 0.9},
    "signum": {"learning_rate": 0.01, "wd_lh": 1e-3},
    "adam": {"learning_rate": 0.01},
    "adamax": {"learning_rate": 0.01},
    "nadam": {"learning_rate": 0.01},
    "ftml": {"learning_rate": 0.01},
    "ftrl": {"learning_rate": 0.1, "lamda1": 0.001},
    "rmsprop": {"learning_rate": 0.01, "clip_weights": 0.4},
    "rmsprop/centered": {"learning_rate": 0.01, "centered": True},
    "adagrad": {"learning_rate": 0.1},
    "adadelta": {},
    "lbsgd": {"learning_rate": 0.1, "momentum": 0.9},
    "dcasgd": {"learning_rate": 0.1, "momentum": 0.9},
    "test": {},
}
COMPILE_SAFE = {"sgd", "ccsgd", "nag", "signum", "adam", "adamax", "ftml",
                "ftrl", "rmsprop", "adagrad", "adadelta"}


def _data(seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(BATCH, 8).astype(dtype) for _ in range(STEPS)]
    ys = [rng.randint(0, 4, BATCH).astype(np.float32) for _ in range(STEPS)]
    return xs, ys


def _jax_mlp(dtype=None):
    mx.random.seed(11)
    net = jgl.nn.HybridSequential()
    net.add(jgl.nn.Dense(16, activation="relu", in_units=8))
    net.add(jgl.nn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier())
    if dtype is not None:
        net.cast(dtype)
    return net


def _port_mlp(params, dtype=None):
    net = nn.HybridSequential(device="cpu")
    net.add(nn.Dense(16, activation="relu", in_units=8, device="cpu"))
    net.add(nn.Dense(4, in_units=16, device="cpu"))
    load_mxnet_tpu_params(net, params)
    if dtype is not None:
        net.cast(dtype)
    return net


def _kwargs(name, sched):
    kw = dict(COMMON, **OPTIMIZERS[name])
    kw["lr_scheduler"] = sched.FactorScheduler(step=2, factor=0.5)
    return name.split("/")[0], kw


def _train_jax(net, name, kw, xs, ys):
    trainer = jgl.Trainer(net.collect_params(), name, kw)
    loss_fn = jgl.loss.SoftmaxCrossEntropyLoss()
    for x, y in zip(xs, ys):
        with jag.record():
            loss = loss_fn(net(mx.nd.array(x, dtype=x.dtype)),
                           mx.nd.array(y))
        loss.backward()
        trainer.step(BATCH)
    return trainer


def _train_port(net, name, kw, xs, ys):
    trainer = gluon.Trainer(net.collect_params(), name, kw)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in zip(xs, ys):
        with autograd.record():
            loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(loss)
        trainer.step(BATCH)
    return trainer


def _params(jnet):
    return {k: p.data().asnumpy().astype(np.float32)
            for k, p in jnet._collect_params_with_prefix().items()}


def test_every_jax_optimizer_is_registered():
    want = set(jopt.optimizer._REG._entries)
    assert want == set(optimizer.optimizer._REGISTRY)
    assert len(want) == 16  # 15 classes and the ccSGD alias
    for name in want:
        jcls = jopt.optimizer._REG._entries[name]
        tcls = optimizer.optimizer._REGISTRY[name]
        assert tcls.__name__ == jcls.__name__
        assert tcls.compiled_step_safe == jcls.compiled_step_safe, name
        assert tcls.compiled_step_safe == (name in COMPILE_SAFE), name


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_trajectory_matches_jax(case):
    xs, ys = _data()
    jnet = _jax_mlp()
    start = _params(jnet)
    jname, jkw = _kwargs(case, jsched)
    jtrainer = _train_jax(jnet, jname, jkw, xs, ys)
    name, kw = _kwargs(case, lr_scheduler)
    net = _port_mlp(start)
    trainer = _train_port(net, name, kw, xs, ys)
    assert trainer.learning_rate == jtrainer.learning_rate
    moved = 0.0
    for k, want in _params(jnet).items():
        got = net.collect_params()[k].detach().numpy()
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
        moved = max(moved, np.abs(want - start[k]).max() / scale)
    assert moved > 1e-4  # the optimizer did train


def test_sgld_noise_law_matches_jax():
    """SGLD adds N(0, lr) noise: both packages' draws from a zero weight
    and gradient have mean 0 and variance lr (their generators differ)."""
    lr, n = 0.04, 200000
    jw = mx.nd.zeros((n,))
    jopt.SGLD(learning_rate=lr).update(0, jw, mx.nd.zeros((n,)), None)
    w = torch.zeros(n)
    optimizer.SGLD(learning_rate=lr).update(0, w, torch.zeros(n), None)
    for draws in (jw.asnumpy(), w.numpy()):
        assert abs(draws.mean()) < 5 * np.sqrt(lr / n)
        assert abs(draws.var() / lr - 1) < 0.02


@pytest.mark.parametrize("name,kw", [
    ("adam", {"learning_rate": 1e-3}),
    ("sgd", {"learning_rate": 0.01, "momentum": 0.9}),
])
def test_multi_precision_float16_matches_jax(name, kw):
    """Each step's float16 gradients come from the JAX package's backward
    and feed both Trainers (the two packages' float16 forwards round
    differently, which is not what this holds): the float32 masters, the
    widened gradients and the weights rounded from the masters."""
    xs, ys = _data(1, np.float16)
    jnet = _jax_mlp()
    start = _params(jnet)
    jnet.cast("float16")
    kw = dict(kw, multi_precision=True)
    jtr = jgl.Trainer(jnet.collect_params(), name, dict(kw))
    net = _port_mlp(start, "float16")
    tr = gluon.Trainer(net.collect_params(), name, dict(kw))
    jparams = jnet._collect_params_with_prefix()
    loss_fn = jgl.loss.SoftmaxCrossEntropyLoss()
    for x, y in zip(xs, ys):
        with jag.record():
            loss = loss_fn(jnet(mx.nd.array(x, dtype=x.dtype)),
                           mx.nd.array(y))
        loss.backward()
        for k, p in net.collect_params().items():
            p.grad = torch.from_numpy(jparams[k].grad().asnumpy())
        jtr.step(BATCH)
        tr.step(BATCH)
    f16 = np.finfo(np.float16)
    for i, (k, p) in enumerate(net.collect_params().items()):
        jstate, state = jtr._updaters[0].states[i], tr._updaters[0].states[i]
        master = state[0]
        assert p.dtype == torch.float16 and master.dtype == torch.float32
        np.testing.assert_allclose(master.numpy(), jstate[0].asnumpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
        want = jparams[k].data().asnumpy()
        got = p.detach().numpy()
        # one step of the type at the larger of the two
        step = np.spacing(np.maximum(np.maximum(np.abs(want), np.abs(got)),
                                     f16.tiny)).astype(np.float32)
        assert (np.abs(got.astype(np.float32) - want.astype(np.float32))
                <= step).all(), k
        # the weight is its master's rounding
        np.testing.assert_array_equal(got, master.numpy().astype(np.float16))
        assert np.abs(master.numpy() - start[k]).max() > 1e-4


def test_bfloat16_weights_get_no_master_in_either_package():
    xs, ys = _data(2)
    jnet = _jax_mlp()
    start = _params(jnet)
    jnet.cast("bfloat16")
    # the JAX package's rule: a master for float16 weights only
    jw = jnet._collect_params_with_prefix()["0.weight"].data()
    jstate = jopt.Adam(multi_precision=True).create_state_multi_precision(
        0, jw)
    assert len(jstate) == 2 and all(s.dtype == jw.dtype for s in jstate)
    net = _port_mlp(start, "bfloat16")
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"multi_precision": True})
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(xs[0]).bfloat16()), torch.from_numpy(ys[0]))
    autograd.backward(loss)
    tr.step(BATCH)
    for state in tr._updaters[0].states.values():
        assert len(state) == 2
        assert all(s.dtype == torch.bfloat16 for s in state)


def _mp_case(name, seed=3):
    rng = np.random.RandomState(seed)
    n = int(T.OP_CASES[name][1].get("num_weights", 1))
    per = len(T.OP_CASES[name][0]) // n
    arrays = []
    for _ in range(n):
        w32 = rng.randn(3, 4).astype(np.float32)
        group = [w32.astype(np.float16), rng.randn(3, 4).astype(np.float16)]
        group += [rng.randn(3, 4).astype(np.float32)
                  for _ in range(per - 3)]  # the momentum, if any
        arrays += group + [w32]
    return arrays


@pytest.mark.parametrize("name", ["mp_sgd_update", "mp_sgd_mom_update",
                                  "multi_mp_sgd_update",
                                  "multi_mp_sgd_mom_update"])
def test_mp_update_ops_in_float16_match_jax(name):
    arrays = _mp_case(name)
    op = jreg.get(name)
    attrs = op.canonicalize_attrs(T.OP_CASES[name][1])
    want = op.fn(*[np.asarray(a) for a in arrays], **attrs)
    want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                    else (want,))]
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    treg.apply_op(name, *tensors, **T.OP_CASES[name][1])
    got = [t.numpy() for t in T.updated(name, tensors)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if w.dtype == np.float16:
            step = np.spacing(np.maximum(np.abs(w), np.abs(g))).astype(
                np.float32)
            assert (np.abs(g.astype(np.float32) - w.astype(np.float32))
                    <= 2 * step).all()
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())


_FED = ("lr", "wd", "t", "lrs", "wds")


@pytest.mark.parametrize("case", sorted(c for c in T.OP_CASES
                                        if T.op_name(c) in T.INPLACE_OPS))
def test_fed_scalars_give_the_floats_bits(case):
    """A captured update reads lr, wd and t as 0-d float32 tensors: each
    op gives the same bits as with the floats."""
    arrays = T.make_inputs(case, seed=5)
    attrs = T.OP_CASES[case][1]

    def run(feed):
        tensors = [torch.from_numpy(a.copy()) for a in arrays]
        kw = dict(attrs)
        for k in _FED:
            if k in kw and feed:
                v = kw[k]
                kw[k] = tuple(torch.tensor(float(e)) for e in v) \
                    if isinstance(v, tuple) else torch.tensor(float(v))
        treg.apply_op(T.op_name(case), *tensors, **kw)
        return T.updated(case, tensors)

    for a, b in zip(run(False), run(True)):
        assert torch.equal(a, b)


def test_pickled_optimizer_leaves_out_its_schedule_and_parameters():
    net = _port_mlp(_params(_jax_mlp()))
    opt = optimizer.Adam(lr_scheduler=lr_scheduler.FactorScheduler(2),
                         multi_precision=True)
    gluon.Trainer(net.collect_params(), opt)
    assert opt.param_dict
    back = pickle.loads(pickle.dumps(opt))
    assert back.lr_scheduler is None and back.param_dict == {}
    assert back.multi_precision and back.beta2 == opt.beta2


def test_updater_states_synced_and_generation():
    upd = optimizer.get_updater(optimizer.SGD(momentum=0.9))
    assert upd.aggregate_updates is False and upd.generation == 0
    w = torch.ones(3)
    upd(0, torch.ones(3), w)
    assert upd.states_synced == {0: True}
    blob = upd.get_states(dump_optimizer=True)
    upd.set_states(blob)
    assert upd.generation == 1 and upd.states_synced == {0: False}
    assert isinstance(upd.states[0], np.ndarray)
    upd(0, torch.ones(3), w)
    assert upd.states_synced == {0: True}
    assert isinstance(upd.states[0], torch.Tensor)


def test_sgld_trains_through_the_trainer():
    """SGLD (not compile-safe, random) through the eager Trainer; the
    other optimizers that are not compile-safe are in the trajectory
    test."""
    net = _port_mlp(_params(_jax_mlp()))
    xs, ys = _data(4)
    before = [p.detach().clone() for p in net.parameters()]
    _train_port(net, "sgld", {"learning_rate": 0.01}, xs[:2], ys[:2])
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                     net.parameters()))
