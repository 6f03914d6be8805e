"""The port's Symbol against the JAX package's: node names, argument,
output and auxiliary lists, shape and type inference, and symbol JSON
that loads in the other package, for train_mnist.py's MLP and LeNet (at
small widths) and a BatchNorm net."""

import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import AttrScope as JAttrScope
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.attribute import AttrScope as TAttrScope
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.name import Prefix as TPrefix

PKGS = {"jax": (jmx, JNameManager), "port": (tmx, TNameManager)}


def mlp(mx, hidden=(32, 16), classes=10):
    """train_mnist.py's build_mlp (784-128-64-10 there)."""
    data = mx.sym.Variable("data")
    net = mx.sym.Flatten(data)
    net = mx.sym.FullyConnected(net, num_hidden=hidden[0], name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=hidden[1], name="fc2")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=classes, name="fc3")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def lenet(mx, filters=(4, 8), hidden=32, classes=10):
    """train_mnist.py's build_lenet (20, 50 filters and 500 there)."""
    data = mx.sym.Variable("data")
    c1 = mx.sym.Convolution(data, kernel=(5, 5), num_filter=filters[0],
                            name="conv1")
    a1 = mx.sym.Activation(c1, act_type="tanh")
    p1 = mx.sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = mx.sym.Convolution(p1, kernel=(5, 5), num_filter=filters[1],
                            name="conv2")
    a2 = mx.sym.Activation(c2, act_type="tanh")
    p2 = mx.sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    fl = mx.sym.Flatten(p2)
    f1 = mx.sym.FullyConnected(fl, num_hidden=hidden, name="fc1")
    a3 = mx.sym.Activation(f1, act_type="tanh")
    f2 = mx.sym.FullyConnected(a3, num_hidden=classes, name="fc2")
    return mx.sym.SoftmaxOutput(f2, name="softmax")


def bn_net(mx):
    """Unnamed nodes, BatchNorm's auxiliary states and a regression head."""
    data = mx.sym.Variable("data")
    # no bias before the BatchNorm, whose true gradient would be 0
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                             no_bias=True)
    net = mx.sym.BatchNorm(net, fix_gamma=False)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="avg")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=3)
    return mx.sym.LinearRegressionOutput(net)


NETS = {"mlp": (mlp, (4, 1, 28, 28)), "lenet": (lenet, (4, 1, 28, 28)),
        "bn": (bn_net, (2, 3, 8, 8))}


def build(pkg, net):
    mx, nm = PKGS[pkg]
    with nm():
        return NETS[net][0](mx)


@pytest.mark.parametrize("net", sorted(NETS))
def test_lists_and_json_equal_jax(net):
    j, t = build("jax", net), build("port", net)
    for what in ("list_arguments", "list_outputs", "list_auxiliary_states",
                 "list_inputs"):
        assert getattr(t, what)() == getattr(j, what)(), what
    assert t.tojson() == j.tojson()
    assert t.attr_dict() == j.attr_dict()


@pytest.mark.parametrize("net", sorted(NETS))
def test_infer_shape_and_type_equal_jax(net):
    j, t = build("jax", net), build("port", net)
    shape = NETS[net][1]
    got, want = t.infer_shape(data=shape), j.infer_shape(data=shape)
    assert [list(map(tuple, s)) for s in got] == \
        [list(map(tuple, s)) for s in want]
    assert t.infer_shape_partial(data=shape) == got
    assert t.infer_type() == j.infer_type()
    assert t.infer_type(np.float16) == j.infer_type(np.float16)


@pytest.mark.parametrize("net", sorted(NETS))
def test_json_crosses_both_ways(net, tmp_path):
    j, t = build("jax", net), build("port", net)
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    in_jax = jmx.sym.load(str(tmp_path / "t.json"))
    in_port = tmx.sym.load(str(tmp_path / "j.json"))
    for a, b in ((in_jax, t), (in_port, j)):
        assert a.list_arguments() == b.list_arguments()
        assert a.list_outputs() == b.list_outputs()
        assert a.list_auxiliary_states() == b.list_auxiliary_states()
    assert in_port.tojson() == j.tojson()
    shape = NETS[net][1]
    assert in_port.infer_shape(data=shape) == t.infer_shape(data=shape)


def test_auto_names_follow_the_counters():
    with TNameManager():
        x = tmx.sym.Variable("x")
        a = tmx.sym.FullyConnected(x, num_hidden=2)
        b = tmx.sym.FullyConnected(a, num_hidden=2)
        c = tmx.sym.Activation(b, act_type="relu")
        d = x + 1.0
    assert (a.name, b.name, c.name, d.name) == (
        "fullyconnected0", "fullyconnected1", "activation0", "plus_scalar0")
    assert b.list_arguments() == ["x", "fullyconnected0_weight",
                                  "fullyconnected0_bias",
                                  "fullyconnected1_weight",
                                  "fullyconnected1_bias"]
    with TPrefix("net_"):
        e = tmx.sym.FullyConnected(x, num_hidden=2, no_bias=True)
    assert e.name == "net_fullyconnected0"
    assert e.list_arguments() == ["x", "net_fullyconnected0_weight"]


def test_attr_scope_and_variable_attrs_as_jax():
    outs = []
    for mx, scope in ((jmx, JAttrScope), (tmx, TAttrScope)):
        with scope(group="a"):
            with scope(lr_mult="0.5"):
                v = mx.sym.Variable("w", shape=(2, 3), wd_mult=0.0,
                                    init=mx.init.Xavier() if mx is jmx
                                    else tmx.init.Xavier())
        outs.append(v.list_attr())
    assert outs[0] == outs[1]
    assert outs[1]["__shape__"] == "(2, 3)" and outs[1]["group"] == "a"


def test_arithmetic_and_graph_queries_as_jax():
    results = []
    for pkg in ("jax", "port"):
        mx, nm = PKGS[pkg]
        with nm():
            a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
            s = (a + b) * 2.0 - (1.0 - a) / b + a ** 2.0 - (-b)
            g = mx.sym.Group([s, a * b])
            internals = s.get_internals()
        results.append((s.list_outputs(), g.list_outputs(),
                        internals.list_outputs(),
                        s.get_children().list_outputs(), s.tojson()))
    assert results[0] == results[1]
    a = tmx.sym.Variable("a")
    x = np.arange(6, dtype=np.float32).reshape(2, 3) + 1
    out = (a * a + 1.0).eval(ctx="cpu", a=tmx.nd.array(x, ctx="cpu"))[0]
    np.testing.assert_array_equal(out.asnumpy(), x * x + 1)
    with pytest.raises(MXNetError, match="truth value"):
        bool(a)


def test_compose_replaces_variables():
    with TNameManager():
        x = tmx.sym.Variable("x")
        body = tmx.sym.FullyConnected(tmx.sym.Variable("h"), num_hidden=4,
                                      name="fc")
        head = tmx.sym.Activation(x, act_type="relu", name="act")
        net = body(h=head)
    assert net.list_arguments() == ["x", "fc_weight", "fc_bias"]
    assert body.list_arguments() == ["h", "fc_weight", "fc_bias"]
    internals = net.get_internals()
    assert "act_output" in internals.list_outputs()
    assert internals["act_output"].name == "act"


def test_infer_shape_errors_and_partial():
    t = build("port", "mlp")
    with pytest.raises(MXNetError, match="inconsistent shape"):
        t.infer_shape(data=(4, 784), fc1_weight=(32, 100))
    with pytest.raises(MXNetError, match="cannot infer"):
        t.infer_shape()
    args, outs, aux = t.infer_shape_partial()
    assert args == [None] * 8 and outs is None and aux == []
    v = tmx.sym.Variable("v", shape=(3, 5))
    net = tmx.sym.FullyConnected(v, num_hidden=2, name="f")
    assert net.infer_shape()[1] == [(3, 2)]


def test_simple_bind_refuses_a_missing_shape():
    with pytest.raises(MXNetError, match="cannot infer"):
        build("port", "mlp").simple_bind(ctx="cpu")


def test_label_and_head_json_attrs_parse_as_jax():
    """MXNet's string attributes in a symbol file (as the C API writes
    them) load in the port as their values."""
    t = build("port", "lenet")
    g = json.loads(t.tojson())
    for node in g["nodes"]:
        if node["op"] == "Convolution":
            node["attrs"]["kernel"] = "(5, 5)"
            node["attrs"]["no_bias"] = "False"
    loaded = tmx.sym.load_json(json.dumps(g))
    assert loaded.infer_shape(data=(4, 1, 28, 28)) == \
        t.infer_shape(data=(4, 1, 28, 28))


FLUENT = {
    "reshape": lambda s: s.reshape((4, 6)),
    "reshape-special": lambda s: s.reshape((0, -1)),
    "sum": lambda s: s.sum(),
    "sum-axis-keepdims": lambda s: s.sum(axis=1, keepdims=True),
    "mean-axis": lambda s: s.mean(axis=(0, 2)),
    "transpose": lambda s: s.transpose(),
    "transpose-axes": lambda s: s.transpose((2, 0, 1)),
    "transpose-varargs": lambda s: s.transpose(1, 2, 0),
    "softmax": lambda s: s.softmax(),
    "softmax-axis": lambda s: s.softmax(axis=1),
    "slice_axis": lambda s: s.slice_axis(axis=1, begin=1, end=3),
    "astype": lambda s: s.astype(np.float16),
    "chain": lambda s: (s * 2.0).transpose((1, 0, 2)).reshape((3, -1))
    .softmax(axis=0).sum(axis=1),
}


@pytest.mark.parametrize("case", sorted(FLUENT))
def test_fluent_methods_build_the_jax_ops(case):
    """Each fluent method of Symbol builds the op the JAX Symbol builds
    (the same JSON, op names and attributes), and the bound graph gives the
    JAX graph's values on the same input (float32, one op each: 1e-6)."""
    x = np.random.RandomState(7).randn(2, 3, 4).astype(np.float32)
    outs, jsons = [], []
    for pkg in ("jax", "port"):
        mx, nm = PKGS[pkg]
        with nm():
            sym = FLUENT[case](mx.sym.Variable("x"))
        jsons.append(sym.tojson())
        ctx = mx.cpu()
        outs.append(sym.eval(ctx=ctx, x=mx.nd.array(x, ctx=ctx))[0]
                    .asnumpy())
    assert jsons[1] == jsons[0]
    ops = [n["op"] for n in json.loads(jsons[1])["nodes"]]
    assert ops[0] == "null" and len(ops) >= 2
    assert outs[1].dtype == outs[0].dtype
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)
