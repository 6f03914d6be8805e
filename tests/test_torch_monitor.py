"""``mx.monitor.Monitor`` (``mx.mon``) of the port against the JAX package
on the CPU.

- On a Gluon ``HybridSequential`` (Dense, Activation, Dense; weights
  carried from the JAX block): the same keys as the JAX package's
  Monitor, plain (every block, ``"<path>_output<i>"``) and hybridized (the
  top block alone: its children fire only while the program is staged,
  which both Monitors skip), and the same values within 1e-6; ``pattern``
  and ``sort``; hooks with detachable handles, fired once a call on a
  hybridized block.
- On an executor (``set_monitor_callback``): one value an output, keyed by
  the symbol's output names, the default statistic JAX's mean absolute
  value; an explicit ``stat_func`` gets numpy arrays.
- Through ``Module.fit(monitor=)``, the reference's executor route: the JAX
  package's ``Module.install_monitor`` raises (it hands the executor to a
  Monitor that takes Gluon blocks), the port's watches every
  ``interval``-th batch with one sync a ``toc``; and through
  ``BucketingModule``, whose buckets bound later are watched too.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon import nn as tnn

CPU = tmx.cpu()


def _nets():
    jmx.random.seed(0)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(8, in_units=5), jnn.Activation("relu"),
             jnn.Dense(3, in_units=8))
    jnet.initialize()
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tnet = tnn.HybridSequential(device="cpu")
    tnet.add(tnn.Dense(8, in_units=5, device="cpu"),
             tnn.Activation("relu"),
             tnn.Dense(3, in_units=8, device="cpu"))
    load_mxnet_tpu_params(tnet, params)
    return jnet, tnet


def _watch(mx, net, x, hybridize, **kw):
    if hybridize:
        net.hybridize()
    mon = mx.monitor.Monitor(1, **kw).install(net)
    out = []
    for _ in range(2):  # the first hybridized call stages the program
        mon.tic()
        net(x)
        out.append(mon.toc())
    return mon, out[-1]


@pytest.mark.parametrize("hybridize", [False, True])
def test_block_keys_and_values_equal_jax(hybridize):
    jnet, tnet = _nets()
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    _, want = _watch(jmx, jnet, jmx.nd.array(x), hybridize)
    tmon, got = _watch(tmx, tnet, torch.from_numpy(x), hybridize)

    def keyed(res, top):
        return {k.replace(top, "TOP"): v for _, k, v in res}

    want, got = keyed(want, jnet.name), keyed(got, tnet.name)
    assert sorted(got) == sorted(want)
    assert sorted(got) == (["TOP_output0"] if hybridize else
                           ["0_output0", "1_output0", "2_output0",
                            "TOP_output0"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7)
        assert isinstance(got[k], np.float32)
    assert tmon.syncs == 2


def test_block_pattern_sort_stat_func_and_hook_handles():
    _, tnet = _nets()
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 5)
                         .astype(np.float32))
    mon = tmx.mon.Monitor(2, stat_func=lambda a: float(np.abs(a).max()),
                          pattern="[02]_", sort=True).install(tnet)
    seen = []
    for _ in range(3):
        mon.tic()
        tnet(x)
        seen.append(mon.toc())
    assert [len(s) for s in seen] == [2, 0, 2]  # every second batch
    assert [k for _, k, _ in seen[0]] == ["0_output0", "2_output0"]
    want = float(np.abs(tnet[0](x).detach().numpy()).max())
    assert seen[0][0][2] == pytest.approx(want)
    assert mon.syncs == 4  # one a watched output: stat_func takes numpy
    # a hook's handle detaches it, on a hybridized block too
    tnet.hybridize()
    calls = []
    pre = tnet.register_forward_pre_hook(lambda b, a: calls.append("pre"))
    post = tnet.register_forward_hook(lambda b, a, o: calls.append("post"))
    tnet(x)
    tnet(x)
    assert calls == ["pre", "post"] * 2
    pre.remove()
    post.remove()
    tnet(x)
    assert calls == ["pre", "post"] * 2


def _mlp(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=8,
                                                name="fc1"), act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h, num_hidden=3,
                                                      name="fc2"),
                                name="softmax")


def test_executor_callback_values():
    sym = _mlp(tmx)
    ex = sym.simple_bind(CPU, data=(4, 6))
    rs = np.random.RandomState(3)
    for name, arr in ex.arg_dict.items():
        if name != "softmax_label":
            arr[:] = rs.randn(*arr.shape)
    mon = tmx.mon.Monitor(1).install(ex)
    mon.tic()
    out = ex.forward(is_train=False)[0].asnumpy()
    res = mon.toc()
    assert [(s, k) for s, k, _ in res] == [(1, "softmax_output")]
    np.testing.assert_allclose(res[0][2], np.abs(out).mean(), rtol=1e-6)
    # a train batch: the outputs are set once (at the read or at backward)
    mon.tic()
    ex.forward(is_train=True)
    ex.backward()
    assert len(mon.toc()) == 1 and mon.syncs == 2
    mon.tic()
    ex.forward(is_train=True)
    ex.outputs
    ex.backward()
    assert len(mon.toc()) == 1 and mon.syncs == 3


def _fit_data():
    rs = np.random.RandomState(4)
    x = rs.randn(48, 6).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.float32) + (x[:, 1] > 0)


def test_fit_monitor_where_jax_module_raises(capsys):
    x, y = _fit_data()
    jmod = jmx.mod.Module(_mlp(jmx), context=jmx.cpu())
    with pytest.raises(AttributeError, match="register_forward_hook"):
        jmod.fit(jmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                 monitor=jmx.monitor.Monitor(2))
    tmod = tmx.mod.Module(_mlp(tmx), context=CPU)
    mon = tmx.mon.Monitor(2)
    tmod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
             monitor=mon, optimizer_params={"learning_rate": 0.1})
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Batch:")]
    # 12 batches, every second one watched, its one output printed
    assert len(lines) == 6 and mon.syncs == 6
    assert [int(l.split()[1]) for l in lines] == [1, 3, 5, 7, 9, 11]
    assert all(l.split()[2] == "softmax_output" for l in lines)
    assert all(np.isfinite(float(l.split()[3])) for l in lines)


def test_bucketing_module_monitor_watches_later_buckets():
    def sym_gen(key):
        data = tmx.sym.sum(tmx.sym.Variable("data"), axis=1)
        h = tmx.sym.FullyConnected(data, num_hidden=4, name="fc")
        return (tmx.sym.SoftmaxOutput(h, name="softmax"), ("data",),
                ("softmax_label",))

    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                  context=CPU)
    mod.bind([("data", (8, 6, 5))], [("softmax_label", (8,))])
    mod.init_params()
    mod.init_optimizer()
    mon = tmx.mon.Monitor(1)
    mod.install_monitor(mon)
    rs = np.random.RandomState(5)
    seen = []
    for key in (6, 3, 3, 6):
        batch = tmx.io.DataBatch(
            [tmx.nd.array(rs.randn(8, key, 5), ctx=CPU)],
            [tmx.nd.array(rs.randint(0, 4, 8), ctx=CPU)], bucket_key=key,
            provide_data=[("data", (8, key, 5))],
            provide_label=[("softmax_label", (8,))])
        mon.tic()
        mod.forward_backward(batch)
        mod.update()
        seen.append([k for _, k, _ in mon.toc()])
    assert seen == [["softmax_output"]] * 4
    assert len(mon.exes) == 2
