"""The rest of the port's Module family against the JAX package on the CPU.

- The executor's read-then-backward route: a train forward whose outputs
  are read before ``backward`` runs the graph once, and the gradients come
  from that run (one Dropout mask for the output and the input gradient,
  the keep share of the JAX package's, whose masks are equal too);
  ``example/module/mnist_mlp.py``'s manual loop (forward, update_metric,
  backward, update) within 1e-5 of the JAX package's after 10 batches.
- ``SequentialModule`` and ``PythonLossModule`` as
  ``tests/test_gluon_contrib.py:161-236`` drive them, every parameter
  within 1e-5 of the JAX package's largest magnitude after 10 steps;
  LeNet cut into a trunk and a head within 1e-6 of the single Module.
- ``Module.reshape``: the JAX package's reshape rebinds from stale host
  copies and loses the training (shown); the port keeps the trained
  weights, agrees with a fresh bind within 1e-6 and takes the executor of
  an earlier shape back.
- ``model.FeedForward``: predictions within 1e-5 of the JAX package's.
- ``CSVIter`` and ``PrefetchingIter``: the JAX package's batches bitwise,
  padding included; F1, MCC (macro and micro) and PearsonCorrelation
  within 1e-6 over several updates; ``mx.sym.contrib`` and
  ``mx.sym.random``.

Parameters are carried from the JAX package (no random draw is
compared); SGD without weight decay, so the no-decay rule that the port
applies and the JAX optimizer does not (``tests/test_torch_module.py``)
plays no part.
"""

import importlib.util
import os
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu_torch.name import NameManager as TNameManager

CPU = tmx.cpu()
TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(which):
    return (jmx, JNameManager) if which == "jax" else (tmx, TNameManager)


def _ctx(which):
    return jmx.cpu() if which == "jax" else CPU


def _close(got, want, tol=TOL):
    for k, w in want.items():
        w = w.asnumpy() if hasattr(w, "asnumpy") else w
        g = got[k].asnumpy() if hasattr(got[k], "asnumpy") else got[k]
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def _host(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _nd(which, params):
    mx, _ = _pkg(which)
    return {k: mx.nd.array(v, ctx=_ctx(which)) for k, v in params.items()}


def _batches(which, x, y, batch):
    mx, _ = _pkg(which)
    return list(mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False))


# ------------------------------------------------ read-then-backward (F1)
def _dropout_masks(which, shape=(64, 1000)):
    mx, _ = _pkg(which)
    mx.random.seed(3)
    mod = mx.mod.Module(mx.sym.Dropout(mx.sym.Variable("data"), p=0.5),
                        label_names=[], context=_ctx(which))
    mod.bind([("data", shape)], inputs_need_grad=True)
    mod.init_params()
    x = mx.nd.ones(shape, ctx=_ctx(which))
    mod.forward(mx.io.DataBatch([x]), is_train=True)
    out = mod.get_outputs()[0].asnumpy()
    mod.backward([mx.nd.ones(shape, ctx=_ctx(which))])
    grad = mod.get_input_grads()[0].asnumpy()
    return out != 0, grad != 0


def test_dropout_mask_of_a_read_output_is_its_gradients():
    jout, jgrad = _dropout_masks("jax")
    tout, tgrad = _dropout_masks("port")
    assert np.array_equal(jout, jgrad)  # the JAX package's masks agree
    assert np.array_equal(tout, tgrad)
    assert abs(tout.mean() - 0.5) < 0.01 and abs(jout.mean() - 0.5) < 0.01
    assert abs(tout.mean() - jout.mean()) < 0.02


def test_read_then_backward_evaluates_the_graph_once_a_batch(monkeypatch):
    calls = []
    real = tmx.executor.Executor._eval

    def counted(self, *a):
        calls.append(a[-1])
        return real(self, *a)

    monkeypatch.setattr(tmx.executor.Executor, "_eval", counted)
    with TNameManager():
        net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
            tmx.sym.Dropout(tmx.sym.Variable("data"), p=0.5), num_hidden=4,
            name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=CPU)
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    ex = mod._exec_group.execs[0]
    for i in range(3):
        batch = tmx.io.DataBatch(
            [tmx.nd.array(rng.randn(8, 6), ctx=CPU)],
            [tmx.nd.array(rng.randint(0, 4, 8), ctx=CPU)])
        del calls[:]
        mod.forward(batch, is_train=True)
        mod.update_metric(tmx.metric.Accuracy(), batch.label)
        mod.backward()
        mod.update()
        assert calls == [True]
        assert ex.forward_runs == i + 1
        assert ex.route == "eager, forward kept"
    # the fit order (no read before backward) runs the fused program
    mod.forward_backward(batch)
    assert ex.route == "eager, fused" and ex.forward_runs == 4


def _mnist_mlp_loop(which, init, n=10):
    mx, nm = _pkg(which)
    if which == "jax":
        spec = importlib.util.spec_from_file_location(
            "mnist_mlp_example", os.path.join(REPO, "example", "module",
                                              "mnist_mlp.py"))
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        sym = example.build_sym()
    else:
        data = mx.sym.Variable("data")
        h = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
        h = mx.sym.Activation(h, act_type="relu")
        h = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
        sym = mx.sym.SoftmaxOutput(h, name="softmax")
    train = mx.io.MNISTIter(image="train", batch_size=64, shuffle=False)
    mod = mx.mod.Module(sym, data_names=("data",),
                        label_names=("softmax_label",), context=_ctx(which))
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label)
    if init is None:
        mx.random.seed(7)
        mod.init_params(mx.init.Xavier())
    else:
        mod.init_params(arg_params=_nd(which, init))
    start = _host(mod.get_params()[0])
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.2})
    metric = mx.metric.Accuracy()
    for _, batch in zip(range(n), train):
        mod.forward(batch, is_train=True)
        mod.update_metric(metric, batch.label)
        mod.backward()
        mod.update()
    return start, _host(mod.get_params()[0]), metric.get()[1]


def test_mnist_mlp_manual_loop_equals_jax():
    init, jparams, jacc = _mnist_mlp_loop("jax", None)
    _, tparams, tacc = _mnist_mlp_loop("port", init)
    for k in jparams:
        assert np.abs(jparams[k] - init[k]).max() > 1e-3, k
    _close(tparams, jparams)
    assert tacc == jacc


# ------------------------------------------------ SequentialModule
def _two_layer(which):
    mx, nm = _pkg(which)
    with nm():
        net1 = mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=8, name="fc1"),
            act_type="relu")
        net2 = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=2, name="fc2"),
            name="softmax")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(net1, label_names=[], context=_ctx(which)))
    seq.add(mx.mod.Module(net2, label_names=["softmax_label"],
                          context=_ctx(which)),
            take_labels=True, auto_wiring=True)
    return seq


def test_sequential_module_trajectory_equals_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 10).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.float32)
    runs = {}
    init = None
    for which in ("jax", "port"):
        mx, _ = _pkg(which)
        seq = _two_layer(which)
        batches = _batches(which, x, y, 16)
        seq.bind(data_shapes=[("data", (16, 10))],
                 label_shapes=[("softmax_label", (16,))])
        if init is None:
            mx.random.seed(5)
            seq.init_params(mx.init.Xavier())
            init = _host(seq.get_params()[0])
        else:
            seq.init_params(arg_params=_nd(which, init))
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        metric = mx.metric.Accuracy()
        for i in range(10):
            batch = batches[i % len(batches)]
            seq.forward(batch, is_train=True)
            seq.update_metric(metric, batch.label)
            seq.backward()
            seq.update()
        runs[which] = (_host(seq.get_params()[0]), metric.get()[1],
                       seq.get_outputs()[0].asnumpy())
        assert seq.output_shapes == [("softmax_output", (16, 2))]
    (jp, jacc, jout), (tp, tacc, tout) = runs["jax"], runs["port"]
    assert sorted(jp) == sorted(tp) == ["fc1_bias", "fc1_weight",
                                        "fc2_bias", "fc2_weight"]
    _close(tp, jp)
    assert tacc == jacc
    np.testing.assert_allclose(tout, jout, rtol=0, atol=TOL)


def test_python_loss_module_trajectory_equals_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(32, 6).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.float32)

    def grad_func(scores, labels):
        s = 1 / (1 + np.exp(-scores.asnumpy()[:, 0]))
        return ((s - labels.asnumpy()) / len(s)).reshape(-1, 1)

    runs, init = {}, None
    for which in ("jax", "port"):
        mx, _ = _pkg(which)
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=1,
                                    name="fc")
        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(net, label_names=[], context=_ctx(which)))
        loss = mx.mod.PythonLossModule(grad_func=grad_func)
        seq.add(loss, take_labels=True, auto_wiring=True)
        (batch,) = _batches(which, x, y, 32)
        seq.bind(data_shapes=[("data", (32, 6))],
                 label_shapes=[("softmax_label", (32,))])
        if init is None:
            mx.random.seed(2)
            seq.init_params(mx.init.Xavier())
            init = _host(seq.get_params()[0])
        else:
            seq.init_params(arg_params=_nd(which, init))
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 10.0})
        for _ in range(10):
            seq.forward(batch, is_train=True)
            seq.backward()
            seq.update()
        assert loss.output_shapes == [("pyloss_output", (32, 1))]
        runs[which] = _host(seq.get_params()[0])
    for k in init:
        assert np.abs(runs["jax"][k] - init[k]).max() > 1e-3
    _close(runs["port"], runs["jax"])


def _lenet(split):
    """LeNet at 4 and 8 filters and 16 hidden, whole or cut at its
    Flatten (the same names either way)."""
    sym = tmx.sym
    with TNameManager():
        net = sym.Variable("data")
        for i, filters in ((1, 4), (2, 8)):
            net = sym.Convolution(net, kernel=(5, 5), num_filter=filters,
                                  name="conv%d" % i)
            net = sym.Activation(net, act_type="tanh")
            net = sym.Pooling(net, pool_type="max", kernel=(2, 2),
                              stride=(2, 2))
        trunk = net
        if split:
            net = sym.Variable("data")
        net = sym.FullyConnected(sym.Flatten(net), num_hidden=16, name="fc1")
        net = sym.Activation(net, act_type="tanh")
        net = sym.FullyConnected(net, num_hidden=10, name="fc2")
        head = sym.SoftmaxOutput(net, name="softmax")
    if not split:
        return tmx.mod.Module(head, context=CPU)
    seq = tmx.mod.SequentialModule()
    seq.add(tmx.mod.Module(trunk, label_names=[], context=CPU))
    seq.add(tmx.mod.Module(head, context=CPU), take_labels=True)
    return seq


def test_lenet_cut_into_a_sequential_module_equals_the_single_module():
    it = tmx.io.MNISTIter(batch_size=8, shuffle=False)
    batches = [next(it) for _ in range(5)]
    params = None
    out = {}
    for split in (False, True):
        mod = _lenet(split)
        mod.bind(it.provide_data, it.provide_label)
        if params is None:
            tmx.random.seed(4)
            mod.init_params(tmx.init.Xavier())
            params = _host(mod.get_params()[0])
        else:
            mod.init_params(arg_params=_nd("port", params))
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9})
        for b in batches:
            mod.forward(b, is_train=True)
            mod.get_outputs()
            mod.backward()
            mod.update()
        out[split] = _host(mod.get_params()[0])
    assert sorted(out[True]) == sorted(out[False])
    _close(out[True], out[False], tol=1e-6)


def test_sequential_module_fit_with_a_monitor():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 10).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.float32)
    seq = _two_layer("port")
    mon = tmx.mon.Monitor(2, pattern=".*output")
    it = tmx.io.NDArrayIter(x, y, batch_size=16)
    seq.fit(it, num_epoch=3, optimizer_params={"learning_rate": 0.5},
            initializer=tmx.init.Xavier(), monitor=mon)
    assert mon.step == 12 and mon.syncs == 6
    assert dict(seq.score(it, "acc"))["accuracy"] > 0.8


# ------------------------------------------------ reshape
def _trained_mlp(which, init=None, steps=3):
    mx, nm = _pkg(which)
    with nm():
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Activation(mx.sym.FullyConnected(
                mx.sym.Variable("data"), num_hidden=16, name="fc1"),
                act_type="relu"), num_hidden=4, name="fc2"),
            name="softmax")
    mod = mx.mod.Module(net, context=_ctx(which))
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
    if init is None:
        mx.random.seed(9)
        mod.init_params(mx.init.Xavier())
    else:
        mod.init_params(arg_params=_nd(which, init))
    start = _host(mod.get_params()[0])
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    rng = np.random.RandomState(0)
    for _ in range(steps):
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(rng.randn(8, 6), ctx=_ctx(which))],
            [mx.nd.array(rng.randint(0, 4, 8), ctx=_ctx(which))]))
        mod.update()
    return mod, start, net


def test_reshape_keeps_the_trained_weights_where_jax_loses_them():
    jmod, init, _ = _trained_mlp("jax")
    trained = _host(jmod._exec_group.execs[0].arg_dict)
    assert np.abs(trained["fc1_weight"] - init["fc1_weight"]).max() > 1e-3
    jmod.reshape([("data", (3, 6))], [("softmax_label", (3,))])
    # the JAX package's fault: the new executor holds the stale host
    # copies of before the training, not the trained weights
    stale = jmod._exec_group.execs[0].arg_dict["fc1_weight"].asnumpy()
    np.testing.assert_array_equal(stale, init["fc1_weight"])

    tmod, _, tnet = _trained_mlp("port", init)
    first = tmod._exec_group.execs[0]
    ttrained = _host(first.arg_dict)
    _close({k: ttrained[k] for k in init}, {k: trained[k] for k in init})
    x = np.random.RandomState(1).randn(5, 6).astype(np.float32)
    for n in (1, 5):
        tmod.reshape([("data", (n, 6))], [("softmax_label", (n,))])
        ex = tmod._exec_group.execs[0]
        assert ex is not first and ex.arg_dict["data"].shape == (n, 6)
        for k in init:  # shared storage: the trained weights
            assert ex.arg_dict[k] is first.arg_dict[k]
            assert ex.grad_dict[k] is first.grad_dict[k]
        tmod.forward(tmx.io.DataBatch([tmx.nd.array(x[:n], ctx=CPU)]),
                     is_train=False)
        fresh = tmx.mod.Module(tnet, context=CPU)
        fresh.bind([("data", (n, 6))], for_training=False)
        fresh.set_params(*tmod.get_params())
        fresh.forward(tmx.io.DataBatch([tmx.nd.array(x[:n], ctx=CPU)]),
                      is_train=False)
        want = fresh.get_outputs()[0].asnumpy()
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(), want,
                                   rtol=0, atol=1e-6 * np.abs(want).max())
    tmod.reshape([("data", (8, 6))], [("softmax_label", (8,))])
    assert tmod._exec_group.execs[0] is first
    # training goes on over the same parameters, gradients and states
    tmod.forward_backward(tmx.io.DataBatch(
        [tmx.nd.array(np.ones((8, 6)), ctx=CPU)],
        [tmx.nd.array(np.zeros(8), ctx=CPU)]))
    tmod.update()
    assert tmod._optimizer.num_update == 4


# ------------------------------------------------ FeedForward
def test_feedforward_predictions_equal_jax(tmp_path):
    rs = np.random.RandomState(3)
    x = rs.randn(40, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32) + (x[:, 1] > 0)
    preds, init = {}, None
    for which in ("jax", "port"):
        mx, nm = _pkg(which)
        with nm():
            net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
                mx.sym.Variable("data"), num_hidden=3, name="fc"),
                name="softmax")
        if init is None:
            w = rs.randn(3, 6).astype(np.float32) * 0.1
            init = {"fc_weight": w, "fc_bias": np.zeros(3, np.float32)}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            model = mx.model.FeedForward(
                net, ctx=_ctx(which), num_epoch=2, numpy_batch_size=16,
                arg_params=_nd(which, init), learning_rate=0.1,
                momentum=0.9)
            # a numpy X is shuffled by numpy's global generator, which the
            # JAX package's executor also draws from at its bind: an
            # iterator without shuffle keeps both packages on one order
            model.fit(mx.io.NDArrayIter(x, y, batch_size=16))
            preds[which] = (model.predict(x),
                            model.score(mx.io.NDArrayIter(x, y,
                                                          batch_size=16)))
            if which == "port":
                model.save(str(tmp_path / "ff"))
                again = mx.model.FeedForward.load(str(tmp_path / "ff"), 2,
                                                  ctx=CPU)
                np.testing.assert_array_equal(again.predict(x),
                                              preds[which][0])
    (jp, jacc), (tp, tacc) = preds["jax"], preds["port"]
    assert tp.shape == jp.shape == (40, 3)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    assert tacc == pytest.approx(jacc, abs=1e-9)
    assert tmx.model.BatchEndParam is tmx.mod.BatchEndParam
    assert jmx.model.BatchEndParam is None  # the JAX package's


# ------------------------------------------------ iterators and metrics
def _batches_of(it):
    return [([d.asnumpy() for d in b.data], [l.asnumpy() for l in b.label],
             b.pad) for b in it]


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_batches_equal_jax(tmp_path, round_batch):
    rs = np.random.RandomState(0)
    data, label = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(data, rs.randn(10, 6), delimiter=",")
    np.savetxt(label, rs.randint(0, 3, (10, 1)), delimiter=",")
    got, want = (_batches_of(mx.io.CSVIter(
        data_csv=str(data), data_shape=(2, 3), label_csv=str(label),
        batch_size=4, round_batch=round_batch)) for mx in (tmx, jmx))
    assert len(got) == len(want) == (3 if round_batch else 2)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[-1][2] == (2 if round_batch else 0)


def test_prefetching_iter_batches_equal_jax():
    rs = np.random.RandomState(1)
    x, y = rs.randn(10, 3).astype(np.float32), np.arange(10.0)
    its = {name: mx.io.PrefetchingIter(
        mx.io.NDArrayIter(x, y, batch_size=4),
        rename_data=[{"data": "x"}], rename_label=[{"softmax_label": "y"}])
        for name, mx in (("port", tmx), ("jax", jmx))}
    for it in its.values():
        assert [d.name for d in it.provide_data] == ["x"]
        assert [d.name for d in it.provide_label] == ["y"]
    for _ in range(2):  # twice: reset restarts the reader
        got, want = _batches_of(its["port"]), _batches_of(its["jax"])
        assert len(got) == len(want) == 3
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            assert gp == wp
            for g, w in zip(gd + gl, wd + wl):
                np.testing.assert_array_equal(g, w)
        for it in its.values():
            it.reset()


@pytest.mark.parametrize("name,kwargs", [
    ("f1", {"average": "macro"}), ("f1", {"average": "micro"}),
    ("mcc", {"average": "macro"}), ("mcc", {"average": "micro"}),
    ("pearson_correlation", {}), ("torch", {}), ("caffe", {})])
def test_metrics_equal_jax(name, kwargs):
    rs = np.random.RandomState(2)
    got, want = (mx.metric.create(name, **kwargs) for mx in (tmx, jmx))
    for _ in range(4):
        if name == "pearson_correlation":
            label = rs.randn(12).astype(np.float32)
            pred = (label + rs.randn(12) * 0.5).astype(np.float32)
        else:
            label = rs.randint(0, 2, 12).astype(np.float32)
            pred = rs.rand(12, 2).astype(np.float32)
        got.update([tmx.nd.array(label, ctx=CPU)],
                   [tmx.nd.array(pred, ctx=CPU)])
        want.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
        assert got.get()[0] == want.get()[0]
        np.testing.assert_allclose(got.get()[1], want.get()[1], rtol=1e-6,
                                   atol=1e-6)


def test_sym_contrib_and_random():
    data = tmx.sym.Variable("data")
    anchors = tmx.sym.contrib.MultiBoxPrior(data, sizes=(0.5, 0.25),
                                            ratios=(1, 2))
    assert tmx.sym.contrib.multibox_prior is tmx.sym.contrib.MultiBoxPrior
    x = tmx.nd.zeros((1, 3, 4, 5), ctx=CPU)
    got = anchors.bind(CPU, {"data": x}).forward()[0].asnumpy()
    want = tmx.nd.contrib.MultiBoxPrior(x, sizes=(0.5, 0.25),
                                        ratios=(1, 2)).asnumpy()
    np.testing.assert_array_equal(got, want)
    u = tmx.sym.random.uniform(low=2.0, high=3.0, shape=(50,))
    n = tmx.sym.random.normal(loc=1.0, scale=0.5, shape=(4, 3))
    uv = u.bind(CPU, {}).forward()[0].asnumpy()
    nv = n.bind(CPU, {}).forward()[0].asnumpy()
    assert uv.shape == (50,) and ((uv >= 2) & (uv < 3)).all()
    assert nv.shape == (4, 3) and np.isfinite(nv).all()
