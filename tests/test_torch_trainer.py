"""Training the port's TransformerLM against the JAX package's: the same
tiny model (vocab 97, units 64, 2 layers, 4 heads, S=64), initialised in
JAX and carried over by load_mxnet_tpu_params, trained on the same fixed
(4, 64) ids and labels through record / backward / SoftmaxCrossEntropyLoss
/ gluon.Trainer in both packages, on the CPU.

Tolerances: the gradients after one backward within 1e-4; every step's
mean loss within 1e-4 relative and the final parameters within 1e-3
absolute over 20 steps (measured: 2e-7 relative and 1.2e-5 absolute; the
float32 sums of each package run in another order and the differences
grow with the steps).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgl
from mxnet_tpu.gluon.nn.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch import MXNetError, autograd, gluon, optimizer
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.nn import Dense, TransformerLM

V, U, L, H, S, B = 97, 64, 2, 4, 64, 4
STEPS = 20
OPTIMIZERS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
              "adam": {"learning_rate": 1e-3}}


@pytest.fixture(scope="module")
def setup():
    mx.random.seed(7)
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, size=(B, S)).astype(np.float32)
    y = rng.randint(0, V, size=(B, S)).astype(np.float32)
    net = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S)
    net.initialize()
    net(mx.nd.array(x))  # finish deferred shapes
    params = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    return x, y, params


def _jax_net(params, x):
    net = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S)
    net.initialize()
    net(mx.nd.array(x))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(params[k]))
    return net


def _port_net(params):
    return load_mxnet_tpu_params(
        TransformerLM(V, units=U, num_layers=L, num_heads=H, max_length=S,
                      device="cpu"), params)


def test_gradients_match_jax_after_one_backward(setup):
    x, y, params = setup
    jnet = _jax_net(params, x)
    with jag.record():
        loss = jgl.loss.SoftmaxCrossEntropyLoss()(jnet(mx.nd.array(x)),
                                                  mx.nd.array(y))
    loss.backward()
    want = {k: p.grad().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}
    net = _port_net(params)
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(x)), torch.from_numpy(y))
    assert loss.shape == (B,)
    autograd.backward(loss)
    for name, p in net._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_training_trajectory_matches_jax(setup, opt):
    x, y, params = setup
    jnet = _jax_net(params, x)
    jloss = jgl.loss.SoftmaxCrossEntropyLoss()
    jtrainer = jgl.Trainer(jnet.collect_params(), opt, dict(OPTIMIZERS[opt]))
    want = []
    for _ in range(STEPS):
        with jag.record():
            loss = jloss(jnet(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        jtrainer.step(B)
        want.append(float(loss.mean().asscalar()))

    net = _port_net(params)
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), opt, dict(OPTIMIZERS[opt]))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = []
    for _ in range(STEPS):
        with autograd.record():
            loss = tloss(net(xt), yt)
        autograd.backward(loss)
        trainer.step(B)
        got.append(float(loss.detach().mean()))

    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = {k: p.data().asnumpy()
             for k, p in jnet._collect_params_with_prefix().items()}
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name], rtol=0, atol=1e-3,
                                   err_msg=name)


def _dense_step(trainer_kw, setup_fn=None, batch=2):
    net = Dense(3, in_units=4, device="cpu").initialize(seed=1)
    if setup_fn:
        setup_fn(net)
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    trainer = gluon.Trainer(net.collect_params(), **trainer_kw)
    x = torch.ones(batch, 4)
    with autograd.record():
        out = net(x)
    autograd.backward(out)
    grads = {k: p.grad.clone()
             for k, p in net._collect_params_with_prefix().items()
             if p.grad is not None}
    trainer.step(batch)
    return net, before, grads, trainer


def test_step_rescales_by_batch_size_and_applies_wd_to_every_parameter():
    net, before, grads, trainer = _dense_step(
        dict(optimizer="sgd", optimizer_params={"learning_rate": 0.5,
                                                "wd": 0.1}), batch=4)
    assert trainer.optimizer.rescale_grad == 0.25
    for name, p in net._collect_params_with_prefix().items():
        want = before[name] - 0.5 * (grads[name] * 0.25 + 0.1 * before[name])
        torch.testing.assert_close(p.detach(), want)


def test_lr_and_wd_multipliers_and_null_grad_req():
    def setup_fn(net):
        net.weight.lr_mult = 2.0
        net.weight.wd_mult = 0.0
        net.bias.grad_req = "null"

    net, before, grads, _ = _dense_step(
        dict(optimizer="sgd", optimizer_params={"learning_rate": 0.5,
                                                "wd": 0.1}),
        setup_fn, batch=2)
    torch.testing.assert_close(net._parameters["weight"].detach(),
                               before["weight"] - 1.0 * grads["weight"] / 2)
    assert torch.equal(net._parameters["bias"].detach(), before["bias"])


def test_learning_rate_and_optimizer_instance():
    opt = optimizer.create("Adam", learning_rate=0.01)
    assert isinstance(opt, optimizer.Adam)
    assert optimizer.create(opt) is opt
    net = Dense(3, in_units=4, device="cpu").initialize()
    trainer = gluon.Trainer(net.collect_params(), opt)
    assert trainer.learning_rate == 0.01
    trainer.set_learning_rate(0.02)
    assert trainer.learning_rate == 0.02 and opt.lr == 0.02
    assert opt.param_dict[0] is net._parameters["weight"]
    with pytest.raises(ValueError):
        gluon.Trainer(net.collect_params(), opt, {"learning_rate": 1.0})
    with pytest.raises(MXNetError, match="not registered"):
        optimizer.create("nosuchopt")


def test_adam_bias_correction_per_index():
    """The bias-corrected lr comes from each index's own update count,
    computed in double on the host."""
    opt = optimizer.Adam(learning_rate=0.1)
    w = torch.zeros(2)
    upd = optimizer.get_updater(opt)
    for _ in range(3):
        upd(0, torch.ones(2), w)
    upd(1, torch.ones(2), torch.zeros(2))
    assert opt._index_update_count == {0: 3, 1: 1} and opt.num_update == 3
    assert opt._bc_lr(0) == 0.1 * (1 - 0.999 ** 3) ** 0.5 / (1 - 0.9 ** 3)


def test_parameter_no_backward_reached_updates_with_a_zero_gradient():
    """The JAX package's gradient buffers start at zero; the port's
    ``.grad`` is None until a backward reaches the parameter, and the
    Trainer reads None as zeros (so weight decay still applies)."""
    used = Dense(3, in_units=4, device="cpu").initialize(seed=2)
    unused = Dense(3, in_units=4, device="cpu").initialize(seed=3)
    params = list(used.parameters()) + list(unused.parameters())
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.5, "wd": 0.1})
    before = unused._parameters["weight"].detach().clone()
    with autograd.record():
        out = used(torch.ones(2, 4))
    autograd.backward(out)
    trainer.step(2)
    assert unused._parameters["weight"].grad is None
    torch.testing.assert_close(unused._parameters["weight"].detach(),
                               before - 0.5 * 0.1 * before)


@pytest.mark.parametrize("kvstore", ["device", "local", None, False])
def test_one_device_kvstores_reduce_nothing(kvstore):
    """The JAX Trainer's keywords (``mxnet_tpu/gluon/trainer.py:110-112``):
    the stores that mean no store on one device are taken, and the step
    is the one without them."""
    net, before, grads, trainer = _dense_step(dict(
        optimizer="sgd", optimizer_params={"learning_rate": 0.5},
        kvstore=kvstore, compression_params=None, update_on_kvstore=False))
    assert trainer._kvstore_type is kvstore and trainer._kvstore is None
    assert trainer._update_on_kvstore is False
    for name, p in net._collect_params_with_prefix().items():
        torch.testing.assert_close(p.detach(),
                                   before[name] - 0.5 * grads[name] / 2)


class _Store:
    type = "local"


@pytest.mark.parametrize("kw", [{"kvstore": "dist_sync"},
                                {"kvstore": "dist_async_device"},
                                {"kvstore": _Store()},
                                {"update_on_kvstore": True}])
def test_stores_that_need_more_devices_raise(kw):
    net = Dense(3, in_units=4, device="cpu").initialize()
    with pytest.raises(MXNetError, match="Queue 1 item 9"):
        gluon.Trainer(net.collect_params(), "sgd", **kw)


def test_jax_trainer_attributes_and_two_phase_update():
    net = Dense(3, in_units=4, device="cpu").initialize(seed=4)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.5, "rescale_grad": 2.0})
    assert trainer._param2idx == {net._parameters["weight"]: 0,
                                  net._parameters["bias"]: 1}
    assert trainer._contexts == [torch.device("cpu")]
    assert len(trainer._updaters) == 1 and trainer._scale == 2.0
    before = net._parameters["weight"].detach().clone()
    with autograd.record():
        out = net(torch.ones(2, 4))
    autograd.backward(out)
    trainer.allreduce_grads()
    trainer.update(4)
    assert trainer.optimizer.rescale_grad == 0.5
    w = net._parameters["weight"]
    torch.testing.assert_close(w.detach(), before - 0.5 * 0.5 * w.grad)
    trainer._update_on_kvstore = True  # the JAX guards of :307-339
    for call in (trainer.allreduce_grads, lambda: trainer.update(4)):
        with pytest.raises(ValueError, match="update_on_kvstore"):
            call()
    other = Dense(3, in_units=4, device="meta")
    with pytest.raises(ValueError, match="one device"):
        gluon.Trainer(list(net.parameters()) + list(other.parameters()),
                      "sgd")


def test_step_telemetry_counts_as_jax():
    """``trainer_steps`` and the ``trainer:step`` histogram (when on)
    count the same steps in both packages."""
    from mxnet_tpu import histogram as jhistogram
    from mxnet_tpu import runtime_stats as jrts
    from mxnet_tpu_torch import histogram, runtime_stats

    was = (jhistogram.is_enabled(), histogram.is_enabled())
    jrts.reset()
    runtime_stats.reset()
    try:
        jnet = mx.gluon.nn.Dense(3, in_units=4)
        jnet.initialize()
        jtr = jgl.Trainer(jnet.collect_params(), "sgd")
        net = Dense(3, in_units=4, device="cpu").initialize()
        tr = gluon.Trainer(net.collect_params(), "sgd")
        for on in (False, True, True):
            for mod in (jhistogram, histogram):
                (mod.enable if on else mod.disable)()
            with jag.record():
                jl = jnet(mx.nd.ones((2, 4)))
            jl.backward()
            jtr.step(2)
            with autograd.record():
                tl = net(torch.ones(2, 4))
            autograd.backward(tl)
            tr.step(2)
        assert runtime_stats.snapshot()["counters"]["trainer_steps"] == 3 \
            == jrts.snapshot()["counters"]["trainer_steps"]
        assert histogram.get("trainer:step").count == 2 == \
            jhistogram.get("trainer:step").count
    finally:
        for mod, on in zip((jhistogram, histogram), was):
            (mod.enable if on else mod.disable)()
        jrts.reset()
        runtime_stats.reset()
