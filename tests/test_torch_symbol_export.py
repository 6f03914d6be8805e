"""Export and deploy: the Symbol path of the port's Gluon layers against
the JAX package's.

The TransformerLM (vocab 100, units 32, 2 layers, 2 heads, S = 16)
exported by the JAX package loads into the port's
``SymbolBlock.imports``, ``mx.model.load_checkpoint`` + ``Predictor`` and
``Module`` (outputs within 1e-5), and the port's export into the JAX
package's ``SymbolBlock.imports``; the port's ``SymbolBlock`` of the JAX
file is differentiable, its gradients within 1e-5 of the JAX Gluon
model's ``autograd`` gradients from the same weights.  Each layer, cell
and loss that gained a Symbol path writes the JAX package's graph (its
JSON equal inside both packages' ``NameManager`` scopes), and the two
graphs give the same outputs on the same seeded inputs (1e-5).
``resnet18_v2`` crosses both ways in both layouts.  The layers the JAX
package cannot trace either raise :class:`MXNetError`.  The JAX package
runs on its CPU path, ``_contrib_flash_attention`` through its XLA-fused
fallback.
"""

import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import NameManager as JaxNameManager
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager
from mxnet_tpu_torch.predictor import Predictor

TOL = 1e-5
VOCAB, UNITS, LAYERS, HEADS, SEQ = 100, 32, 2, 2, 16


def _lm(mx):
    return mx.gluon.nn.TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                                     num_heads=HEADS, prefix="transformerlm0_")


def _ids(seed=0, batch=2):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (batch, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """The JAX TransformerLM (Xavier weights), its logits on seeded ids
    and its exported files."""
    path = str(tmp_path_factory.mktemp("jax") / "lm")
    jmx.random.seed(0)
    net = _lm(jmx)
    net.initialize(jmx.init.Xavier())
    x = _ids()
    want = net(jmx.nd.array(x, dtype="int32")).asnumpy()
    net.hybridize()
    net(jmx.nd.array(x, dtype="int32"))
    net.export(path)
    return net, x, want, path


def test_jax_export_loads_into_the_port(jax_export):
    _, x, want, path = jax_export
    with tmx.cpu():
        sb = tmx.gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                           path + "-0000.params")
    assert sorted(sb.collect_params()) == sorted(
        jax_export[0].collect_params())
    for ids in (x, x.astype(np.float32)):  # as exported, as served
        got = sb(torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    with tmx.cpu():
        nd_out = sb(tmx.nd.array(x, dtype="int32"))
    np.testing.assert_allclose(nd_out.asnumpy(), want, rtol=0, atol=TOL)


def test_jax_export_through_load_checkpoint_predictor_and_module(
        jax_export):
    _, x, want, path = jax_export
    sym, arg_params, aux_params = tmx.model.load_checkpoint(path, 0,
                                                            ctx=tmx.cpu())
    assert not aux_params and len(arg_params) == 2 + 12 * LAYERS + 3
    with open(path + "-symbol.json") as f, \
            open(path + "-0000.params", "rb") as g:
        pred = Predictor(f.read(), g.read(), {"data": x.shape},
                         dev_type="cpu")
    pred.forward(data=x.astype(np.float32))
    np.testing.assert_allclose(pred.get_output(0), want, rtol=0, atol=TOL)
    mod = tmx.mod.Module(sym, data_names=["data"], label_names=None,
                         context=tmx.cpu())
    mod.bind(data_shapes=[("data", x.shape)], for_training=False)
    mod.set_params(arg_params, aux_params)
    mod.forward(tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())]),
                is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want,
                               rtol=0, atol=TOL)


def test_port_export_loads_into_jax(tmp_path):
    path = str(tmp_path / "lm")
    x = _ids(1)
    with tmx.cpu():
        net = _lm(tmx)
        net.initialize(tmx.init.Xavier())
    want = net(torch.from_numpy(x)).numpy()
    net.hybridize()
    net(torch.from_numpy(x))
    net.export(path)
    jsb = jmx.gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                        path + "-0000.params")
    got = jsb(jmx.nd.array(x, dtype="int32")).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # and back into the port, bitwise
    with tmx.cpu():
        own = tmx.gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                            path + "-0000.params")
    assert torch.equal(own(torch.from_numpy(x)), net(torch.from_numpy(x)))


def test_symbol_block_gradients_match_jax_gluon(jax_export):
    """The port's SymbolBlock of the JAX file, through the registered
    _contrib_flash_attention's backward, against the JAX Gluon model's
    autograd gradients of the same loss from the same weights."""
    jnet, x, _, path = jax_export
    label = np.random.RandomState(5).randint(0, VOCAB, (2, SEQ))
    jx = jmx.nd.array(x, dtype="int32")
    with jmx.autograd.record():
        loss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(jx), jmx.nd.array(label))
    loss.backward()
    with tmx.cpu():
        sb = tmx.gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                           path + "-0000.params")
        with tmx.autograd.record():
            tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
                sb(tmx.nd.array(x, dtype="int32")),
                tmx.nd.array(label.astype(np.float32)))
        tloss.backward()
    np.testing.assert_allclose(tloss.asnumpy(), loss.asnumpy(), rtol=0,
                               atol=TOL)
    for name, p in jnet.collect_params().items():
        got = sb.collect_params()[name].grad().asnumpy()
        want = p.grad().asnumpy()
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()),
                                   err_msg=name)


# ------------------------------------------- each layer's graph, both ways

def _cell_step(cls, n_states, **kwargs):
    def make(mx):
        return getattr(mx.gluon.rnn, cls)(5, input_size=4, prefix="c_",
                                          **kwargs)
    return make, [("data", (3, 4))] + [("s%d" % i, (3, 5))
                                       for i in range(n_states)]


def _wrapped(wrapper, n_states):
    def make(mx):
        return getattr(mx.gluon.rnn, wrapper)(mx.gluon.rnn.GRUCell(
            4, input_size=4, prefix="g_"))
    return make, [("data", (3, 4))] + [("s%d" % i, (3, 4))
                                       for i in range(n_states)]


def _stack():
    def make(mx):
        seq = mx.gluon.rnn.SequentialRNNCell(prefix="stack_")
        with seq.name_scope():
            seq.add(mx.gluon.rnn.LSTMCell(5, input_size=4))
            seq.add(mx.gluon.rnn.DropoutCell(0.0))
            seq.add(mx.gluon.rnn.RNNCell(3, input_size=5,
                                         activation="relu"))
        return seq
    return make, [("data", (3, 4)), ("s0", (3, 5)), ("s1", (3, 5)),
                  ("s2", (3, 3))]


def _layer(build, *inputs):
    return build, list(inputs)


def _vision(mx):
    return mx.gluon.model_zoo.vision


GRAPHS = {
    "LayerNorm": _layer(lambda mx: mx.gluon.nn.LayerNorm(
        in_channels=6, prefix="ln_"), ("data", (2, 3, 6))),
    "Embedding": _layer(lambda mx: mx.gluon.nn.Embedding(
        10, 6, prefix="emb_"), ("data", (2, 5), 10)),
    "ReflectionPad2D": _layer(lambda mx: mx.gluon.nn.ReflectionPad2D(
        2, prefix="pad_"), ("data", (2, 3, 5, 6))),
    "RNNCell": _cell_step("RNNCell", 1),
    "LSTMCell": _cell_step("LSTMCell", 2),
    "GRUCell": _cell_step("GRUCell", 1),
    "ResidualCell": _wrapped("ResidualCell", 1),
    "SequentialRNNCell": _stack(),
    "SoftmaxCrossEntropyLoss": _layer(
        lambda mx: mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        ("pred", (4, 7)), ("label", (4,), 7)),
    "SoftmaxCrossEntropyLoss/weighted": _layer(
        lambda mx: mx.gluon.loss.SoftmaxCrossEntropyLoss(
            axis=1, weight=0.5),
        ("pred", (4, 7, 2)), ("label", (4, 2), 7),
        ("sample_weight", (4, 1, 2))),
    "KLDivLoss": _layer(lambda mx: mx.gluon.loss.KLDivLoss(
        from_logits=False, weight=2.0), ("pred", (4, 7)), ("label", (4, 7))),
    "BasicBlockV2": _layer(lambda mx: _vision(mx).BasicBlockV2(
        8, 2, True, in_channels=4, prefix="b_"), ("data", (2, 4, 6, 6))),
    "BottleneckV2/nhwc": _layer(lambda mx: _vision(mx).BottleneckV2(
        16, 2, True, in_channels=8, layout="NHWC", prefix="b_"),
        ("data", (2, 6, 6, 8))),
    "MultiHeadAttention": _layer(lambda mx: mx.gluon.nn.MultiHeadAttention(
        8, 2, causal=True, prefix="mha_"), ("data", (2, 5, 8))),
    "PositionwiseFFN/relu": _layer(lambda mx: mx.gluon.nn.PositionwiseFFN(
        8, 16, activation="relu", prefix="ffn_"), ("data", (2, 5, 8))),
    "TransformerEncoderCell": _layer(
        lambda mx: mx.gluon.nn.TransformerEncoderCell(
            8, 16, 2, prefix="cell_"), ("data", (2, 5, 8))),
    "TransformerEncoder": _layer(lambda mx: mx.gluon.nn.TransformerEncoder(
        2, 8, 16, 2, causal=True, prefix="enc_"), ("data", (2, 5, 8))),
    "TransformerLM": _layer(lambda mx: mx.gluon.nn.TransformerLM(
        20, 8, 1, 2, prefix="lm_"), ("data", (2, 5), 20)),
}


def _graph(mx, name_manager, make, inputs):
    # a fresh scope: the blocks a layer makes outside its own scope (the
    # v2 blocks' children) are named by its counters, not the process's
    holder = mx.gluon.Block(prefix="scope_")
    with name_manager(), holder.name_scope():
        block = make(mx)
        syms = [mx.sym.var(spec[0]) for spec in inputs]
        if isinstance(block, (mx.gluon.rnn.RecurrentCell,)):
            out, states = block(syms[0], syms[1:])
            return mx.sym.Group([out] + list(states))
        return block(*syms)


def _without_global_stats(graph):
    """The JSON with BatchNorm's use_global_stats dropped: the JAX
    package's export fixes the statistics (ROADMAP "deliberate
    divergences"), the port's keeps MXNet's train-mode update."""
    g = json.loads(graph)
    for node in g["nodes"]:
        if node["op"] == "BatchNorm":
            node["attrs"].pop("use_global_stats", None)
    return g


def _arrays(sym, inputs, seed):
    """Seeded arrays for every argument and auxiliary state of the JAX
    graph: an input given as (name, shape, n) holds integers in [0, n)
    (ids, class labels); a KLDivLoss label is a distribution; variances
    are positive."""
    ints = {spec[0]: spec[2] for spec in inputs if len(spec) == 3}
    arg_shapes, _, aux_shapes = sym.infer_shape(
        **{spec[0]: spec[1] for spec in inputs})
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in list(zip(sym.list_arguments(), arg_shapes)) + list(
            zip(sym.list_auxiliary_states(), aux_shapes)):
        if name in ints:
            a = rng.randint(0, ints[name], shape)
        elif name == "label":
            a = rng.dirichlet(np.ones(shape[-1]), shape[:-1])
        elif name.endswith(("running_var", "moving_var")):
            a = rng.uniform(0.5, 2.0, shape)
        else:
            a = rng.randn(*shape)
        out[name] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_layer_graph_equals_jax(case):
    make, inputs = GRAPHS[case]
    with tmx.cpu():
        tsym = _graph(tmx, NameManager, make, inputs)
    jsym = _graph(jmx, JaxNameManager, make, inputs)
    assert _without_global_stats(tsym.tojson()) == \
        _without_global_stats(jsym.tojson())
    # the two graphs on the same arrays (predict mode)
    arrays = _arrays(jsym, inputs, seed=3)
    aux = set(jsym.list_auxiliary_states())
    jex = jsym.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in arrays.items()
                                if k not in aux},
                    aux_states={k: jmx.nd.array(arrays[k]) for k in aux})
    want = [o.asnumpy() for o in jex.forward(is_train=False)]
    tex = tsym.bind(tmx.cpu(), {k: tmx.nd.array(v, ctx=tmx.cpu())
                                for k, v in arrays.items() if k not in aux},
                    aux_states={k: tmx.nd.array(arrays[k], ctx=tmx.cpu())
                                for k in aux})
    got = [o.asnumpy() for o in tex.forward(is_train=False)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_v2_export_crosses_both_ways(layout, tmp_path):
    shape = (2, 3, 32, 32) if layout == "NCHW" else (2, 32, 32, 3)
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    jnet = _vision(jmx).resnet18_v2(classes=10, layout=layout,
                                    prefix="resnetv20_")
    jmx.random.seed(1)
    jnet.initialize(jmx.init.Xavier())
    want = jnet(jmx.nd.array(x)).asnumpy()
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    jnet.export(str(tmp_path / "jax"))
    with tmx.cpu():
        tsb = tmx.gluon.SymbolBlock.imports(
            str(tmp_path / "jax-symbol.json"), ["data"],
            str(tmp_path / "jax-0000.params"))
        got = tsb(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    with tmx.cpu():
        tnet = _vision(tmx).resnet18_v2(classes=10, layout=layout,
                                        prefix="resnetv20_")
    tnet.load_parameters(_saved(jnet, tmp_path))
    own = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(own, want, rtol=0, atol=TOL)
    tnet.export(str(tmp_path / "port"))
    jsb = jmx.gluon.SymbolBlock.imports(str(tmp_path / "port-symbol.json"),
                                        ["data"],
                                        str(tmp_path / "port-0000.params"))
    np.testing.assert_allclose(jsb(jmx.nd.array(x)).asnumpy(), own, rtol=0,
                               atol=TOL)


def _saved(jnet, tmp_path):
    path = str(tmp_path / "jax.params")
    jnet.save_parameters(path)
    return path


def _no_path():
    vision = tmx.gluon.model_zoo.vision
    return {
        "rnn.LSTM": (lambda: tmx.gluon.rnn.LSTM(4, input_size=3), 1),
        "rnn.GRU": (lambda: tmx.gluon.rnn.GRU(4, input_size=3), 1),
        "L1Loss": (lambda: tmx.gluon.loss.L1Loss(), 2),
        "HuberLoss": (lambda: tmx.gluon.loss.HuberLoss(), 2),
        "CTCLoss": (lambda: tmx.gluon.loss.CTCLoss(), 2),
        "SoftmaxCELoss/dense-label": (
            lambda: tmx.gluon.loss.SoftmaxCrossEntropyLoss(
                sparse_label=False), 2),
        "PixelShuffle2D": (lambda: tmx.gluon.contrib.nn.PixelShuffle2D(2),
                           1),
        "Concurrent": (lambda: tmx.gluon.contrib.nn.Concurrent(), 1),
        "resnet s2d stem": (lambda: vision.resnet18_v1(
            layout="NHWC", stem_s2d=True), 1),
    }


@pytest.mark.parametrize("case", sorted(_no_path()))
def test_layers_the_jax_package_cannot_trace_raise(case):
    make, n = _no_path()[case]
    with tmx.cpu():
        block = make()
    with pytest.raises(MXNetError, match="none either"):
        block(*[tmx.sym.var("in%d" % i) for i in range(n)])


def test_a_cells_unroll_over_a_symbol_raises():
    with tmx.cpu():
        cell = tmx.gluon.rnn.LSTMCell(4, input_size=3)
    with pytest.raises(MXNetError, match="none either"):
        cell.unroll(3, tmx.sym.var("data"))
    with pytest.raises(MXNetError, match="none either"):
        cell.unroll(2, [tmx.sym.var("a"), tmx.sym.var("b")])


def test_symbol_block_infers_shapes_through_flash_attention(tmp_path):
    """A SymbolBlock over the port's export, without its parameter file:
    the shapes are inferred through _contrib_flash_attention on meta
    tensors, which reaches no kernel."""
    from mxnet_tpu_torch.ops import attention

    with tmx.cpu():
        net = tmx.gluon.nn.TransformerLM(20, 8, 1, 2, prefix="lm_")
    sym = net(tmx.sym.var("data"))
    before = attention.flash_attention.launches
    with tmx.cpu():
        sb = tmx.gluon.SymbolBlock(sym, tmx.sym.var("data"))
        sb.initialize()
        out = sb(torch.zeros(2, 5))
    assert out.shape == (2, 5, 20)
    assert sb.collect_params()["lm_enc_layers_transformerencodercell0_"
                               "attn_proj_weight"].shape == (8, 8)
    assert attention.flash_attention.launches == before
    arg_shapes, out_shapes, _ = sym.infer_shape(data=(3, 7))
    assert out_shapes == [(3, 7, 20)]
