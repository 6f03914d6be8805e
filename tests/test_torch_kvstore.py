"""The port's one-device ``mx.kv`` (mxnet_tpu_torch/kvstore/) against the
JAX package's, on the CPU: the names, init/push/pull/pushpull, updaters,
the optimizer on the store, two-bit compression, the optimizer-state
files in both directions, and the store under ``Module`` and
``gluon.Trainer``.

Tolerances: pushed sums and custom updaters' results are equal
exactly; the stores' values after SGD-with-momentum pushes (compressed or
not) within 1e-6 relative, a few float32 units in the last place (XLA
may fuse the update's multiply-adds, PyTorch rounds each); a Module's
parameters through a store and without one are equal exactly.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.gluon.nn import Dense

CPU = tmx.cpu()


def _t(a):
    return tmx.nd.array(np.asarray(a, np.float32), ctx=CPU)


def _j(a):
    return jmx.nd.array(np.asarray(a, np.float32))


@pytest.mark.parametrize("name", ["local", "device", "nccl", "tpu",
                                  "local_update_cpu", "local_allreduce_cpu",
                                  "local_allreduce_device", "LOCAL"])
def test_single_process_names_are_one_store(name):
    kv, jkv = tmx.kv.create(name), jmx.kv.create(name)
    assert isinstance(kv, tmx.kv.KVStore)
    assert kv.type == jkv.type == name.lower()
    assert (kv.rank, kv.num_workers) == (jkv.rank, jkv.num_workers) == (0, 1)
    kv.barrier()


@pytest.mark.parametrize("name", ["dist_sync", "dist_async", "dist",
                                  "dist_sync_device"])
def test_distributed_stores_raise_naming_the_queue_item(name):
    with pytest.raises(MXNetError, match="Queue 1 item 9"):
        tmx.kv.create(name)


def test_bad_names_raise():
    with pytest.raises(MXNetError, match="unknown"):
        tmx.kv.create("bogus")
    with pytest.raises(TypeError):
        tmx.kv.create(3)
    assert tmx.kv is tmx.kvstore


def test_init_push_pull_semantics_match():
    kv, jkv = tmx.kv.create(), jmx.kv.create()
    rs = np.random.RandomState(0)
    a, b, c = (rs.normal(size=(3, 4)).astype(np.float32) for _ in range(3))
    kv.init("w", _t(a))
    jkv.init("w", _j(a))
    kv.init([3, 4], [_t(b), _t(c)])
    jkv.init([3, 4], [_j(b), _j(c)])
    with pytest.raises(MXNetError, match="already"):
        kv.init("w", _t(a))
    # without an updater a push replaces the value with the pushed sum
    kv.push("w", [_t(b), _t(c), _t(a)])
    jkv.push("w", [_j(b), _j(c), _j(a)])
    out, jout = _t(np.zeros((3, 4))), _j(np.zeros((3, 4)))
    kv.pull("w", out=out)
    jkv.pull("w", out=jout)
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    # lists of keys; pushpull
    outs = [_t(np.zeros((3, 4))), _t(np.zeros((3, 4)))]
    jouts = [_j(np.zeros((3, 4))), _j(np.zeros((3, 4)))]
    kv.pushpull([3, 4], [_t(c), [_t(a), _t(b)]], out=outs)
    jkv.pushpull([3, 4], [_j(c), [_j(a), _j(b)]], out=jouts)
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o.asnumpy(), jo.asnumpy())
    # a pulled array is a copy: writing it leaves the store alone
    outs[0][:] = 0.0
    kv.pull(3, out=outs[1])
    np.testing.assert_array_equal(outs[1].asnumpy(), jouts[0].asnumpy())
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push("missing", _t(a))
    with pytest.raises(MXNetError, match="not initialized"):
        kv.pull("missing", out=out)
    # 3 pushes replaced a (3, 4) float32 value and 4 pulls copied one
    assert kv.copied_bytes == 7 * 48


def test_custom_updater_sees_the_pushed_sum_and_the_stored_value():
    calls = {}

    def updater(key, pushed, stored):
        calls[key] = (pushed.asnumpy().copy(), stored.asnumpy().copy())
        stored[:] = stored * 0.5 + pushed

    kv, jkv = tmx.kv.create(), jmx.kv.create()
    kv.set_updater(updater)
    jcalls = {}

    def jupdater(key, pushed, stored):
        jcalls[key] = (pushed.asnumpy().copy(), stored.asnumpy().copy())
        stored[:] = stored * 0.5 + pushed

    jkv._set_updater(jupdater)
    kv.init("9", _t(np.ones((2, 2))))
    jkv.init("9", _j(np.ones((2, 2))))
    for step in range(3):
        g = np.full((2, 2), step + 1.0, np.float32)
        kv.push("9", [_t(g), _t(g)])
        jkv.push("9", [_j(g), _j(g)])
    assert list(calls) == list(jcalls) == [9]
    for x, y in zip(calls[9], jcalls[9]):
        np.testing.assert_array_equal(x, y)
    out, jout = _t(np.zeros((2, 2))), _j(np.zeros((2, 2)))
    kv.pull("9", out=out)
    jkv.pull("9", out=jout)
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())


def _sgd_stores(seed=0, steps=3, compression=None):
    rs = np.random.RandomState(seed)
    w = rs.normal(size=(5, 3)).astype(np.float32)
    grads = [rs.normal(size=(5, 3)).astype(np.float32) for _ in range(steps)]
    stores = []
    for pkg, arr in ((tmx, _t), (jmx, _j)):
        kv = pkg.kv.create("local")
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                           wd=0.01))
        if compression:
            kv.set_gradient_compression(compression)
        kv.init("w", arr(w))
        for g in grads:
            kv.push("w", arr(g))
        stores.append(kv)
    return stores


def _pulled(kv, pkg):
    out = (_t if pkg is tmx else _j)(np.zeros((5, 3)))
    kv.pull("w", out=out)
    return out.asnumpy()


@pytest.mark.parametrize("compression", [None, {"type": "2bit",
                                                "threshold": 0.5}])
def test_optimizer_on_the_store_matches(compression):
    kv, jkv = _sgd_stores(compression=compression)
    np.testing.assert_allclose(_pulled(kv, tmx), _pulled(jkv, jmx),
                               rtol=1e-6, atol=1e-7)
    if compression:
        with pytest.raises(MXNetError, match="2bit"):
            kv.set_gradient_compression({"type": "1bit"})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_optimizer_state_files_cross_both_ways(tmp_path, writer):
    """One package's store saves its momentum after 3 pushes; a fresh
    store of the other package loads it, takes the writer's weight, and
    the next push moves both stores alike."""
    kv, jkv = _sgd_stores()
    src, src_pkg = (kv, tmx) if writer == "port" else (jkv, jmx)
    path = str(tmp_path / "s.states")
    src.save_optimizer_states(path)
    fresh, jfresh = _sgd_stores(steps=0)
    dst, dst_pkg = (jfresh, jmx) if writer == "port" else (fresh, tmx)
    dst.load_optimizer_states(path)
    arr = _t if dst_pkg is tmx else _j
    dst._store["w"] = arr(_pulled(src, src_pkg))
    g = np.random.RandomState(9).normal(size=(5, 3)).astype(np.float32)
    src.push("w", (_t if src_pkg is tmx else _j)(g))
    dst.push("w", arr(g))
    np.testing.assert_allclose(_pulled(dst, dst_pkg), _pulled(src, src_pkg),
                               rtol=1e-6, atol=1e-7)


def test_the_port_reads_its_own_dumped_optimizer(tmp_path):
    kv, _ = _sgd_stores()
    path = str(tmp_path / "d.states")
    kv.save_optimizer_states(path, dump_optimizer=True)
    fresh, _ = _sgd_stores(steps=0)
    fresh.load_optimizer_states(path)
    state = fresh._updater.states["w"]
    np.testing.assert_array_equal(np.asarray(state),
                                  kv._updater.states["w"].numpy())


# ------------------------------------------------------------ Module


def _mlp():
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def _module(kvstore, compression=None):
    mod = tmx.mod.Module(_mlp(), context=CPU,
                         compression_params=compression)
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    mod.init_params(tmx.init.Xavier(rnd_type="gaussian"))
    rs = np.random.RandomState(1)
    mod.set_params({k: _t(rs.normal(0, 0.3, v.shape))
                    for k, v in mod.get_params()[0].items()}, {})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3})
    return mod


def _train(mod, steps=3):
    rs = np.random.RandomState(2)
    for _ in range(steps):
        batch = tmx.io.DataBatch([_t(rs.normal(size=(4, 5)))],
                                 [_t(rs.randint(0, 3, 4))])
        mod.forward_backward(batch)
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_through_a_store_equals_local_and_moves_nothing(tmp_path):
    kv = tmx.kv.create("local")
    mod = _module(kv)
    assert mod._update_on_kvstore and mod._updater is kv._updater
    bound = mod._exec_group.execs[0].arg_dict
    for name in mod._param_names:
        # the store holds the bound parameter itself
        assert kv._store[name] is bound[name]
    ptrs = {n: bound[n].data_torch.data_ptr() for n in mod._param_names}
    got = _train(mod)
    assert {n: kv._store[n].data_torch.data_ptr()
            for n in mod._param_names} == ptrs
    assert kv.copied_bytes == 0
    want = _train(_module("local"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(kv._updater.states) == sorted(mod._param_names)
    path = str(tmp_path / "m.states")
    mod.save_optimizer_states(path)
    again = _module(tmx.kv.create("local"))
    again.load_optimizer_states(path)
    assert sorted(again._kvstore._updater.states) == sorted(
        mod._param_names)


def _jax_module(kvstore):
    data = jmx.sym.Variable("data")
    net = jmx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = jmx.sym.Activation(net, act_type="relu")
    net = jmx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    mod = jmx.mod.Module(jmx.sym.SoftmaxOutput(net, name="softmax"),
                         context=jmx.cpu())
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    mod.init_params(jmx.init.Xavier(rnd_type="gaussian"))
    rs = np.random.RandomState(1)
    mod.set_params({k: _j(rs.normal(0, 0.3, v.shape))
                    for k, v in mod.get_params()[0].items()}, {})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3})
    rs = np.random.RandomState(2)
    for _ in range(3):
        mod.forward_backward(jmx.io.DataBatch(
            [_j(rs.normal(size=(4, 5)))], [_j(rs.randint(0, 3, 4))]))
        mod.update()
    return mod


def _named_states(mod):
    """A Module's optimizer states by parameter name, as numpy."""
    if mod._update_on_kvstore:
        return {k: np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
                for k, v in mod._kvstore._updater.states.items()}
    keys = getattr(mod, "_update_keys", None) or range(
        len(mod._param_names))
    index = dict(zip(keys, mod._param_names))
    return {index[k]: np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                                 else v)
            for k, v in mod._updater.states.items()}


@pytest.mark.parametrize("reader", ["store", "plain"])
@pytest.mark.parametrize("writer", ["port store", "port plain", "jax store",
                                    "jax plain"])
def test_module_state_files_load_across_keyings(tmp_path, writer, reader):
    """A Module on a store saves its states keyed by name, one without a
    store keyed by position (in both packages); the port's Module reads
    either kind, from either package, whichever way it updates: the
    momentum carries over, and a port-written one steps on alike."""
    pkg, kind = writer.split()
    if pkg == "port":
        src = _module(tmx.kv.create("local") if kind == "store" else "local")
        _train(src)
    else:
        src = _jax_module(jmx.kv.create("local") if kind == "store"
                          else "local")
    assert src._update_on_kvstore == (kind == "store")
    path = str(tmp_path / "w.states")
    src.save_optimizer_states(path)
    dst = _module(tmx.kv.create("local") if reader == "store" else "local")
    dst.load_optimizer_states(path)
    want, got = _named_states(src), _named_states(dst)
    assert sorted(got) == sorted(want) == sorted(dst._param_names)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(np.abs(v).max() > 0 for v in got.values())
    if pkg == "port":
        dst.set_params(*src.get_params())
        after, again = _train(src, 1), _train(dst, 1)
        for k in after:
            np.testing.assert_array_equal(again[k], after[k], err_msg=k)


def test_module_refuses_states_of_other_parameters(tmp_path):
    kv = tmx.kv.create("local")
    kv.init("other", _t(np.zeros(3)))
    kv.set_optimizer(tmx.optimizer.create("sgd", momentum=0.9))
    kv.push("other", _t(np.ones(3)))
    path = str(tmp_path / "o.states")
    kv.save_optimizer_states(path)
    for store in (tmx.kv.create("local"), "local"):
        mod = _module(store)
        with pytest.raises(MXNetError, match="'other' match no parameter"):
            mod.load_optimizer_states(path)
    fresh = tmx.kv.create("local")
    fresh.init("w", _t(np.zeros(3)))
    fresh.set_optimizer(tmx.optimizer.create("sgd", momentum=0.9))
    with pytest.raises(MXNetError, match="'other' match no parameter"):
        fresh.load_optimizer_states(path)


def test_module_store_compression_matches_the_store_alone():
    comp = {"type": "2bit", "threshold": 0.05}
    mod = _module(tmx.kv.create("local"), compression=comp)
    assert mod._kvstore._compression.threshold == 0.05
    params = _train(mod, steps=2)
    assert all(np.isfinite(v).all() for v in params.values())


def test_module_refuses_what_is_not_a_store():
    for kv in ("dist_sync", object()):
        with pytest.raises(MXNetError, match="kvstore"):
            _module(kv)


# ------------------------------------------------------------ Trainer


def _dense_steps(kvstore, compiled=False):
    net = Dense(3, in_units=4, device="cpu").initialize(seed=2)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.5, "momentum": 0.9},
                            kvstore=kvstore)
    x = torch.from_numpy(np.random.RandomState(0).normal(
        size=(2, 4)).astype(np.float32))
    y = torch.tensor([0.0, 2.0])
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    if compiled:
        cs = trainer.compile(net, loss)
        for _ in range(3):
            cs.step(x, y)
        assert len(cs.graphs) == 1
    else:
        for _ in range(3):
            with autograd.record():
                out = loss(net(x), y)
            autograd.backward(out)
            trainer.step(2)
    return [p.detach().clone() for p in net.parameters()]


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
def test_trainer_takes_a_one_device_store(compiled):
    got = _dense_steps(tmx.kv.create("device"), compiled)
    want = _dense_steps("local", compiled)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
