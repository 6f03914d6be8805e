"""The port's Module against the JAX package's on the CPU, with
train_mnist.py's networks at small widths (the MLP 784-32-16-10, LeNet
with 4 and 8 filters) on the synthetic digits: ``fit`` with
common/fit.py's SGD settings (lr 0.05, momentum 0.9, wd 1e-4, a
MultiFactorScheduler, rescale_grad 1/batch), 2 epochs of 3 batches,
``shuffle=False``, from the JAX Module's initial parameters, leaves every
parameter within 1e-4 of the JAX Module's largest magnitude; ``score`` and
``predict`` agree; checkpoints cross both ways.

The JAX Module is given an SGD whose ``set_wd_mult({})`` was called:
MXNet's optimizer applies the no-decay rule (no weight decay on names
that end neither in ``_weight`` nor in ``_gamma``) in its constructor,
which the port does and the JAX package's optimizer does not."""

import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from test_torch_symbol import build

CPU = tmx.cpu()
BATCH, BATCHES, EPOCHS = 16, 3, 2
TOL = 1e-4


def _digits(n, flat=False):
    """The first ``n`` synthetic training digits of both packages."""
    it = tmx.io.MNISTIter(batch_size=n, shuffle=False, flat=flat)
    b = next(iter(it))
    return b.data[0].asnumpy(), b.label[0].asnumpy()


def _settings(mx):
    return {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
            "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                step=[4], factor=0.1)}


def _jax_module(net, x, y):
    sym = build("jax", net)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    it = jmx.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    mod.bind(it.provide_data, it.provide_label)
    jmx.random.seed(11)
    mod.init_params(jmx.init.Xavier())
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    sgd = jmx.optimizer.create(
        "sgd", sym=sym, rescale_grad=1.0 / BATCH,
        param_idx2name=dict(enumerate(mod._param_names)), **_settings(jmx))
    sgd.set_wd_mult({})
    return mod, it, init, sgd


def _port_module(net, x, y, init):
    mod = tmx.mod.Module(build("port", net), context=CPU)
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    args = {k: tmx.nd.array(v, ctx=CPU) for k, v in init.items()}
    return mod, it, args


@pytest.mark.parametrize("net", ["mlp", "lenet"])
def test_fit_trajectory_score_and_predict_equal_jax(net):
    x, y = _digits(BATCH * BATCHES)
    jmod, jit, init, sgd = _jax_module(net, x, y)
    jmod.fit(jit, num_epoch=EPOCHS, optimizer=sgd, eval_metric="acc")
    tmod, tit, args = _port_module(net, x, y, init)
    seen = []
    tmod.fit(tit, num_epoch=EPOCHS, optimizer="sgd",
             optimizer_params=_settings(tmx), eval_metric="acc",
             arg_params=args,
             batch_end_callback=[tmx.callback.Speedometer(BATCH, 2),
                                 lambda p: seen.append((p.epoch, p.nbatch))])
    assert seen == [(e, b) for e in range(EPOCHS) for b in range(BATCHES)]
    assert tmod._optimizer.num_update == EPOCHS * BATCHES
    jargs, targs = jmod.get_params()[0], tmod.get_params()[0]
    assert sorted(jargs) == sorted(targs)
    for k in jargs:
        w = jargs[k].asnumpy()
        moved = np.abs(w - init[k]).max()
        assert moved > 1e-3, k  # the check has something to see
        np.testing.assert_allclose(targs[k].asnumpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max())
    for metric in ("acc", "ce"):
        got = tmod.score(tmx.io.NDArrayIter(x, y, batch_size=BATCH), metric)
        want = jmod.score(jmx.io.NDArrayIter(x, y, batch_size=BATCH), metric)
        assert got[0][0] == want[0][0]
        np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-4)
    # predict over a padded last batch: the pad is cut off
    got = tmod.predict(tmx.io.NDArrayIter(x[:40], y[:40], batch_size=BATCH))
    want = jmod.predict(jmx.io.NDArrayIter(x[:40], y[:40],
                                           batch_size=BATCH))
    assert got.shape == want.shape == (40, 10)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=0,
                               atol=1e-5)


def test_fit_validation_and_checkpoints_cross_both_ways(tmp_path):
    x, y = _digits(BATCH * BATCHES)
    jmod, jit, init, sgd = _jax_module("mlp", x, y)
    tmod, tit, args = _port_module("mlp", x, y, init)
    prefix = str(tmp_path / "port")
    tmod.fit(tit, eval_data=tmx.io.NDArrayIter(x, y, batch_size=BATCH),
             num_epoch=1, optimizer="sgd", optimizer_params=_settings(tmx),
             eval_metric="acc", arg_params=args,
             epoch_end_callback=tmx.callback.do_checkpoint(prefix))
    # the port's checkpoint in the JAX package
    jloaded = jmx.mod.Module.load(prefix, 1, context=jmx.cpu())
    jloaded.bind(jit.provide_data, jit.provide_label, for_training=False)
    want = tmod.predict(tmx.io.NDArrayIter(x, y, batch_size=BATCH))
    got = jloaded.predict(jmx.io.NDArrayIter(x, y, batch_size=BATCH))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=0,
                               atol=1e-5)
    # the JAX package's checkpoint in the port
    jmod.fit(jit, num_epoch=1, optimizer=sgd)
    jprefix = str(tmp_path / "jax")
    jmod.save_checkpoint(jprefix, 3)
    tloaded = tmx.mod.Module.load(jprefix, 3, context=CPU)
    tloaded.bind(tit.provide_data, tit.provide_label, for_training=False)
    got = tloaded.predict(tmx.io.NDArrayIter(x, y, batch_size=BATCH))
    want = jmod.predict(jmx.io.NDArrayIter(x, y, batch_size=BATCH))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=0,
                               atol=1e-5)
    sym, a, aux = tmx.model.load_checkpoint(jprefix, 3, ctx=CPU)
    assert sym.tojson() == jmod.symbol.tojson() and aux == {}
    assert sorted(a) == sorted(jmod.get_params()[0])


def test_optimizer_states_and_module_checkpoint(tmp_path):
    x, y = _digits(BATCH * 2)
    tmod = tmx.mod.Module(build("port", "mlp"), context=CPU)
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    prefix = str(tmp_path / "m")
    tmod.fit(it, num_epoch=1, optimizer="sgd",
             optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
             initializer=tmx.init.Xavier(),
             epoch_end_callback=tmx.callback.module_checkpoint(
                 tmod, prefix, save_optimizer_states=True))
    again = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                context=CPU)
    again.bind(it.provide_data, it.provide_label)
    again.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9})
    states = again._updater.states
    assert sorted(states) == list(range(6))
    for i, s in tmod._updater.states.items():
        np.testing.assert_array_equal(states[i], s.numpy())
    # the next step of each continues from the same state
    batch = next(iter(tmx.io.NDArrayIter(x, y, batch_size=BATCH)))
    for m in (tmod, again):
        m.forward_backward(batch)
        m.update()
    for k, v in tmod.get_params()[0].items():
        np.testing.assert_array_equal(again.get_params()[0][k].asnumpy(),
                                      v.asnumpy())


def test_no_decay_rule_and_symbol_multipliers():
    sym = build("port", "lenet")
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    with tmx.AttrScope(__lr_mult__="0.5"):
        w = tmx.sym.Variable("extra_weight", wd_mult=2.0)
    sgd = tmx.optimizer.create(
        "sgd", learning_rate=0.1, wd=0.01, sym=tmx.sym.Group([sym, w]),
        param_idx2name=dict(enumerate(names + ["extra_weight"])))
    wds = {n: sgd._get_wd(i) for i, n in enumerate(names)}
    assert wds == {n: (0.01 if n.endswith("_weight") else 0.0)
                   for n in names}
    extra = len(names)
    assert sgd._get_wd(extra) == pytest.approx(0.02)
    assert sgd._get_lr(extra) == pytest.approx(0.05)
    jsgd = jmx.optimizer.create(
        "sgd", learning_rate=0.1, wd=0.01,
        param_idx2name=dict(enumerate(names)))
    jsgd.set_wd_mult({})
    assert {n: jsgd._get_wd(i) for i, n in enumerate(names)} == wds
    # Trainer's param_dict keeps deciding for Gluon
    assert tmx.optimizer.create("sgd", wd=0.01)._get_wd(0) == 0.01


def test_scheduler_drives_the_rate_and_begin_num_update():
    sched = tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    sgd = tmx.optimizer.create("sgd", learning_rate=1.0, lr_scheduler=sched,
                               begin_num_update=4)
    assert sgd.learning_rate == sched(4) == 0.5
    sgd._update_count(0)
    assert sgd.num_update == 5 and sgd._get_lr(0) == sched(5) == 0.25
    with pytest.raises(MXNetError, match="LRScheduler"):
        sgd.set_learning_rate(0.1)


def test_one_device_only():
    sym = build("port", "mlp")
    with pytest.raises(MXNetError, match="multi-GPU"):
        tmx.mod.Module(sym, context=[CPU, CPU])
    mod = tmx.mod.Module(sym, context=[CPU])
    mod.bind([("data", (4, 1, 28, 28))], [("softmax_label", (4,))])
    mod.init_params()
    for kv in ("dist_sync", object()):
        with pytest.raises(MXNetError, match="kvstore"):
            mod.init_optimizer(kvstore=kv, force_init=True)
    mod.init_optimizer(kvstore="device")
    mod.init_optimizer(kvstore=None, force_init=True)


def test_input_grads_and_fixed_params(caplog):
    x, y = _digits(8)
    mod = tmx.mod.Module(build("port", "mlp"), context=CPU,
                         fixed_param_names=["fc1_weight"])
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)],
             inputs_need_grad=True)
    mod.init_params(tmx.init.Normal(0.1))
    with caplog.at_level(logging.WARNING):
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    assert "Already bound" in caplog.text
    mod.init_optimizer()
    before = mod.get_params()[0]["fc1_weight"].asnumpy().copy()
    batch = tmx.io.DataBatch([tmx.nd.array(x, ctx=CPU)],
                             [tmx.nd.array(y, ctx=CPU)])
    mod.forward_backward(batch)
    mod.update()
    assert mod.get_input_grads()[0].shape == x.shape
    np.testing.assert_array_equal(mod.get_params()[0]["fc1_weight"]
                                  .asnumpy(), before)
    assert mod.output_shapes == [("softmax_output", (8, 10))]


def test_iter_predict_and_borrow_optimizer():
    """``iter_predict`` yields each batch's outputs without the pad;
    a Module that borrows another's optimizer updates through its
    states (one momentum per parameter index, shared)."""
    x, y = _digits(40)
    mod = tmx.mod.Module(build("port", "mlp"), context=CPU)
    it = tmx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    got = [(outs[0].shape, n, b.pad) for outs, n, b in mod.iter_predict(it)]
    assert got == [((16, 10), 0, 0), ((16, 10), 1, 0), ((8, 10), 2, 8)]
    other = tmx.mod.Module(build("port", "mlp"), context=CPU)
    other.bind(it.provide_data, it.provide_label, shared_module=mod)
    other.borrow_optimizer(mod)
    assert other._updater is mod._updater
    batch = next(iter(tmx.io.NDArrayIter(x, y, batch_size=BATCH)))
    other.forward_backward(batch)
    other.update()
    assert sorted(mod._updater.states) == list(range(6))
    # the shared parameters moved for both modules
    for k, v in other.get_params()[0].items():
        np.testing.assert_array_equal(
            mod._exec_group.execs[0].arg_dict[k].asnumpy(), v.asnumpy())
