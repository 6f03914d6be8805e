"""The Gluon user API of the PyTorch port against the JAX package.

Names (``prefix``, ``name``, ``collect_params`` and its ``select``) of a
user block with ``name_scope``, nested ``HybridSequential``s and a small
``ResNetV1``, each built with an explicit prefix in both packages; the
parameter handles (``data``, ``grad``, ``set_data``, ``list_*``,
``zero_grad``, ``Constant``, ``setattr``, ``lr_mult``) through three SGD
steps of the Trainer against the JAX trajectory; legacy prefixed-name
files; the repairs of the reference API (NDArray calls, ``initialize``'s
signature, ``collect_params``' keys and values); ``Context`` scopes; and
``autograd.grad(create_graph=True)`` against JAX's second and third
derivatives.  Inputs are seeded numpy arrays; tolerances are stated at
each check.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5


def _user_net(mx, prefix):
    """A user block: a name scope holding a nested HybridSequential of
    two Dense layers (the first with an activation), a Dropout-free
    head and a Constant."""

    class Net(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.body = mx.gluon.nn.HybridSequential()
                with self.body.name_scope():
                    self.body.add(mx.gluon.nn.Dense(6, activation="relu",
                                                    in_units=5),
                                  mx.gluon.nn.Dense(4, in_units=6))
                self.head = mx.gluon.nn.Dense(3, in_units=4)
                self.scale = self.params.get_constant(
                    "scale", np.full((3,), 0.5, np.float32))

        def hybrid_forward(self, F, x, scale):
            return F.broadcast_mul(self.head(F.relu(self.body(x))),
                                   F.reshape(scale, shape=(1, 3)))

    return Net(prefix=prefix)


def _resnet(mx, prefix):
    vision = mx.gluon.model_zoo.vision
    return vision.ResNetV1(vision.BasicBlockV1, [1, 1, 1, 1],
                           [8, 8, 16, 16, 32], classes=5, prefix=prefix)


def _transformer(mx, prefix):
    return mx.gluon.nn.TransformerLM(100, units=32, num_layers=2,
                                     num_heads=2, prefix=prefix)


def _names(block):
    out = [(block.prefix, block.name)]
    for child in (block._modules.values() if hasattr(block, "_modules")
                  else block._children.values()):
        if child is not None:
            out.extend(_names(child))
    return out


@pytest.mark.parametrize("make", [_user_net, _resnet, _transformer],
                         ids=["user", "resnet", "transformer"])
def test_prefixes_names_and_collect_params_equal_jax(make):
    with tmx.cpu():
        t = make(tmx, "model_")
    j = make(jmx, "model_")
    assert _names(t) == _names(j)
    assert list(t.collect_params().keys()) == list(j.collect_params().keys())
    for select in (".*weight", ".*gamma|.*beta|.*bias", "model_stage2_.*"):
        assert list(t.collect_params(select).keys()) == \
            list(j.collect_params(select).keys())
    assert list(t._collect_params_with_prefix().keys()) == \
        list(j._collect_params_with_prefix().keys())
    assert type(t.collect_params()).__name__ == "ParameterDict"
    assert t.collect_params().prefix == j.collect_params().prefix


def test_resnet50_v1_keys_equal_jax():
    vision_t = tmx.gluon.model_zoo.vision
    vision_j = jmx.gluon.model_zoo.vision
    with tmx.cpu():
        t = vision_t.resnet50_v1(prefix="resnetv10_")
    j = vision_j.resnet50_v1(prefix="resnetv10_")
    keys = list(t.collect_params().keys())
    assert keys == list(j.collect_params().keys())
    assert keys[0] == "resnetv10_conv2d0_weight" and len(keys) == 299


def test_unscoped_counters_name_blocks_by_class():
    with tmx.cpu():
        a, b = tmx.gluon.nn.Dense(2), tmx.gluon.nn.Dense(2)
        seq = tmx.gluon.nn.HybridSequential(prefix="s_")
        with seq.name_scope():
            seq.add(tmx.gluon.nn.Dense(2), tmx.gluon.nn.Dense(2))
    assert a.prefix != b.prefix and a.prefix.startswith("dense")
    assert [c.prefix for c in seq] == ["s_dense0_", "s_dense1_"]
    assert a.weight.name == a.prefix + "weight"


def _seeded_pair(seed=0):
    """The user net in both packages with the same weights (the JAX
    package's draws copied into the port by name)."""
    rng = np.random.RandomState(seed)
    j = _user_net(jmx, "net_")
    j.initialize(jmx.init.Xavier())
    with tmx.cpu():
        t = _user_net(tmx, "net_")
        t.initialize()
    for name, p in j.collect_params().items():
        t.collect_params()[name].set_data(p.data().asnumpy())
    x = rng.rand(4, 5).astype(np.float32)
    y = rng.rand(4, 3).astype(np.float32)
    return t, j, x, y


def test_parameter_handles_data_grad_and_list_api():
    t, j, x, _ = _seeded_pair()
    w = t.body[0].weight
    assert isinstance(w, tmx.gluon.Parameter) and w.shape == (6, 5)
    assert w.dtype == np.float32 and w.grad_req == "write"
    # a zero gradient buffer before the first backward, as in the JAX
    # package, and the same buffer after it
    g0 = w.grad()
    assert isinstance(g0, tmx.nd.NDArray) and not g0.asnumpy().any()
    with tmx.cpu(), tmx.autograd.record():
        out = t(tmx.nd.array(x))
    out.backward()
    with jmx.autograd.record():
        jout = j(jmx.nd.array(x))
    jout.backward()
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=0,
                               atol=TOL)
    assert w.grad() .data_torch is g0.data_torch
    for name, p in j.collect_params().items():
        if p.grad_req == "null":
            continue
        tp = t.collect_params()[name]
        np.testing.assert_allclose(tp.grad().asnumpy(), p.grad().asnumpy(),
                                   rtol=0, atol=TOL, err_msg=name)
        assert len(tp.list_grad()) == len(tp.list_data()) == 1
    assert w.list_ctx() == [tmx.cpu()] and t.collect_params().list_ctx() \
        == [tmx.cpu()]
    # data() is the storage without a copy; set_data writes in place
    storage = t.body[0]._parameters["weight"]
    assert w.data().data_torch is storage
    w.set_data(np.ones((6, 5), np.float32))
    assert t.body[0]._parameters["weight"] is storage
    assert storage.detach().eq(1).all()
    t.collect_params().zero_grad()
    assert not w.grad().asnumpy().any()
    const = t.collect_params()["net_scale"]
    assert isinstance(const, tmx.gluon.Constant)
    assert const.grad_req == "null" and const.data().asnumpy().tolist() \
        == [0.5] * 3
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        const.grad()
    with pytest.raises(ValueError, match="shape mismatch"):
        w.set_data(np.ones((5, 6), np.float32))


def test_trainer_trajectory_with_wd_and_lr_mult_matches_jax():
    """Three SGD steps (momentum 0.9, wd 0.01) with the biases' wd_mult
    set to 0 through collect_params(select).setattr and one weight's
    lr_mult 0.5: the port's weights track the JAX package's within 1e-5."""
    t, j, x, y = _seeded_pair(1)
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}
    trainers = []
    for net in (t, j):
        net.collect_params(".*bias").setattr("wd_mult", 0.0)
        net.head.weight.lr_mult = 0.5
    trainers = (tmx.gluon.Trainer(t.collect_params(), "sgd", dict(kw)),
                jmx.gluon.Trainer(j.collect_params(), "sgd", dict(kw)))
    assert t.head._parameters["weight"].lr_mult == 0.5
    assert t.body[0]._parameters["bias"].wd_mult == 0.0
    for _ in range(3):
        for mx, net, trainer in ((tmx, t, trainers[0]),
                                 (jmx, j, trainers[1])):
            with mx.autograd.record():
                loss = ((net(mx.nd.array(x, ctx=mx.cpu()))
                         - mx.nd.array(y, ctx=mx.cpu())) ** 2).sum()
            loss.backward()
            trainer.step(4)
    for name, p in j.collect_params().items():
        np.testing.assert_allclose(
            t.collect_params()[name].data().asnumpy(), p.data().asnumpy(),
            rtol=0, atol=TOL, err_msg=name)


def test_legacy_prefixed_files_load_with_missing_and_extra(tmp_path):
    j = _user_net(jmx, "net_")
    j.initialize(jmx.init.Xavier())
    legacy = str(tmp_path / "legacy.params")
    j.collect_params().save(legacy)  # keyed by the full prefixed names
    with tmx.cpu():
        t = _user_net(tmx, "net_")
    t.load_parameters(legacy)
    for name, p in j.collect_params().items():
        assert np.array_equal(t.collect_params()[name].data().asnumpy(),
                              p.data().asnumpy()), name
    # a file that lacks one parameter and holds one this block lacks
    arrays = {k: p.data().asnumpy()
              for k, p in j._collect_params_with_prefix().items()}
    arrays.pop("head.bias")
    arrays["extra.weight"] = np.zeros(2, np.float32)
    odd = str(tmp_path / "odd.params")
    tmx.nd.save(odd, {k: tmx.nd.array(v, ctx=tmx.cpu())
                      for k, v in arrays.items()})
    with tmx.cpu():
        fresh = _user_net(tmx, "net_")
    with pytest.raises(IOError, match="missing"):
        fresh.load_parameters(odd, ignore_extra=True)
    with pytest.raises(IOError, match="not present"):
        fresh.load_parameters(odd, allow_missing=True)
    fresh.load_parameters(odd, allow_missing=True, ignore_extra=True)
    assert np.array_equal(fresh.head.weight.data().asnumpy(),
                          arrays["head.weight"])
    # the ParameterDict's own save and load, prefix stripped and restored
    pfile = str(tmp_path / "pd.params")
    t.collect_params().save(pfile, strip_prefix="net_")
    fresh.collect_params().load(pfile, restore_prefix="net_")
    assert np.array_equal(fresh.head.bias.data().asnumpy(),
                          t.head.bias.data().asnumpy())
    # the aliases
    t.save_params(str(tmp_path / "a.params"))
    fresh.load_params(str(tmp_path / "a.params"))


def test_f1_blocks_take_ndarrays_and_give_ndarrays():
    """F1: a HybridSequential of two Dense layers called on an NDArray
    (the dtype promotion of its inputs raised on numpy dtypes) gives an
    NDArray equal to the tensor call; tensors in still give tensors."""
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(4, in_units=3), tmx.gluon.nn.Dense(2))
        net.initialize(seed=3)
        x = np.random.RandomState(3).rand(5, 3).astype(np.float32)
        out = net(tmx.nd.array(x))
        assert isinstance(out, tmx.nd.NDArray) and out.shape == (5, 2)
        tout = net(torch.from_numpy(x))
        assert isinstance(tout, torch.Tensor)
        assert np.array_equal(out.asnumpy(), tout.numpy())
        net.hybridize()
        assert np.array_equal(net(tmx.nd.array(x)).asnumpy(), tout.numpy())


def test_a_dropped_net_is_freed_without_the_collector():
    """A block, its parameter handles and their storage hold no reference
    cycle: dropping the last reference to a trained, hybridized net frees
    its parameters at once, with the cyclic collector off."""
    gc.collect()
    gc.disable()
    try:
        with tmx.cpu():
            net = _resnet(tmx, "cyc_")
            net.initialize(tmx.init.Xavier())
            net.hybridize()
            trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1})
            x = tmx.nd.array(np.random.RandomState(5).rand(
                2, 3, 16, 16).astype(np.float32))
            with tmx.autograd.record():
                loss = net(x).sum()
            loss.backward()
            trainer.step(2)
        storage = weakref.ref(next(iter(net.parameters())))
        handle = weakref.ref(net.output.weight)
        del net, trainer, loss
        assert storage() is None and handle() is None
    finally:
        gc.enable()


def test_f2_initialize_takes_the_reference_signature():
    """F2: initialize(init, ctx, verbose, force_reinit); ctx places the
    parameters; an initialized parameter is kept unless force_reinit;
    ``seed`` stays keyword-only."""
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize(tmx.init.Xavier(), tmx.cpu(), False)
    first = net.weight.data().asnumpy().copy()
    assert net.weight.list_ctx() == [tmx.cpu()]
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    assert np.array_equal(net.weight.data().asnumpy(), first)
    net.initialize(tmx.init.One(), ctx=tmx.cpu(), force_reinit=True)
    assert (net.weight.data().asnumpy() == 1).all()
    net.initialize(tmx.init.Uniform(0.5), force_reinit=True, seed=7)
    again = tmx.gluon.nn.Dense(3, in_units=4, device="cpu")
    again.initialize(tmx.init.Uniform(0.5), seed=7)
    assert np.array_equal(net.weight.data().asnumpy(),
                          again.weight.data().asnumpy())
    with pytest.raises(TypeError):
        net.initialize(None, None, False, False, 7)


def test_f3_collect_params_keys_values_and_select():
    """F3: collect_params(select) gives a ParameterDict of handles keyed
    by prefixed names; the structural names are
    _collect_params_with_prefix()."""
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential(prefix="hs_")
        with net.name_scope():
            net.add(tmx.gluon.nn.Dense(4, in_units=3),
                    tmx.gluon.nn.Dense(2, in_units=4))
    params = net.collect_params()
    assert list(params) == ["hs_dense0_weight", "hs_dense0_bias",
                            "hs_dense1_weight", "hs_dense1_bias"]
    assert list(net.collect_params(".*bias")) == ["hs_dense0_bias",
                                                  "hs_dense1_bias"]
    assert list(net._collect_params_with_prefix()) == [
        "0.weight", "0.bias", "1.weight", "1.bias"]
    params["hs_dense1_weight"].set_data(np.ones((2, 4), np.float32))
    assert net[1]._parameters["weight"].detach().eq(1).all()
    net.collect_params(".*bias").setattr("wd_mult", 0)
    assert [p.wd_mult for p in params.values()] == [1.0, 0, 1.0, 0]


def test_context_scope_and_default():
    ctx = tmx.cpu()
    assert str(ctx) == "cpu(0)" and ctx.device_type == "cpu"
    assert ctx == tmx.Context("cpu", 0) and ctx == torch.device("cpu")
    assert tmx.gpu(1) != tmx.gpu(0) and str(tmx.gpu(1)) == "gpu(1)"
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        arr = tmx.nd.ones((2,))
        layer = tmx.gluon.nn.Dense(2, in_units=2)
    assert arr.context == torch.device("cpu")
    assert layer.weight.list_ctx() == [tmx.cpu()]
    assert tmx.current_context() == tmx.gpu(0)
    assert tmx.num_gpus() == torch.cuda.device_count()
    assert tmx.cpu_pinned().device_type == "cpu_pinned"


def test_without_a_card_or_a_scope_the_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.gluon.nn.Dense(2, in_units=2)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.nd.ones((2,))
    loader = tmx.gluon.data.DataLoader(
        tmx.gluon.data.ArrayDataset(np.ones((4, 2), np.float32)),
        batch_size=2)
    with pytest.raises(MXNetError, match="no CUDA device"):
        next(iter(loader))


def test_block_helpers_apply_summary_register_child_guard(capsys):
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential(prefix="m_")
        with net.name_scope():
            net.add(tmx.gluon.nn.Dense(4, in_units=3))
        extra = tmx.gluon.nn.Dense(2, in_units=4)
        net.register_child(extra)
        net.initialize()
    seen = []
    assert net.apply(lambda b: seen.append(type(b).__name__)) is net
    assert seen == ["Dense", "Dense", "HybridSequential"]
    with tmx.cpu():
        net.summary(tmx.nd.ones((2, 3)))
    assert "Total params: %d" % (3 * 4 + 4 + 4 * 2 + 2) in \
        capsys.readouterr().out

    class Holder(tmx.gluon.Block):
        def __init__(self):
            super().__init__(device="cpu")
            self.w = self.params.get("w", shape=(2,))

    h = Holder()
    with pytest.raises(TypeError, match="Changing attribute type"):
        h.w = tmx.gluon.nn.Dense(2, device="cpu")


def _third_order(mx, value):
    w = mx.nd.array([value], ctx=mx.cpu())
    w.attach_grad()
    with mx.autograd.record():
        out = w * w * w * w
        (d1,) = mx.autograd.grad(out, [w], create_graph=True)
        (d2,) = mx.autograd.grad(d1, [w], create_graph=True)
        (d3,) = mx.autograd.grad(d2, [w])
    return d1.asnumpy(), d2.asnumpy(), d3.asnumpy()


@pytest.mark.parametrize("value", [2.0, -0.5])
def test_higher_order_gradients_match_jax(value):
    for got, want in zip(_third_order(tmx, value), _third_order(jmx, value)):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    x = tmx.nd.array([1.0, 2.0, 3.0], ctx=tmx.cpu())
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.sin(x) * x
        (dx,) = tmx.autograd.grad(y, [x], create_graph=True)
    dx.backward()
    xs = np.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(x.grad.asnumpy(),
                               2 * np.cos(xs) - xs * np.sin(xs), rtol=1e-5)
