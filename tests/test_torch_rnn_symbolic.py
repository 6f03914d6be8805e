"""The port's symbolic recurrent cells (``mx.rnn``) against the JAX
package's on the CPU.

Each cell is built in both packages inside ``NameManager`` scopes, so the
argument lists and the symbol JSON are equal; both are bound at the same
shapes with the same seeded arguments, run forward in train mode and
backward with the same seeded head gradients.  Outputs (the merged
sequence and the last states) and every argument's gradient agree within
1e-5 of each JAX array's largest magnitude.  Covered: RNNCell (tanh,
relu), LSTMCell, GRUCell, SequentialRNNCell, DropoutCell (p = 0),
ResidualCell, ZoneoutCell (no zoneout), BidirectionalCell, the fused
cell in lstm/gru/rnn_tanh, one- and two-way, its unpacked weights, pack
and ``unfuse``, the begin states (``zeros``: batch 1; ``Variable``:
batch 0, solved by partial shape inference), ``SwapAxis``, the ``RNN``
shape rule, ``LSTMBias`` and ``FusedRNN`` initialisation, Xavier's law
and the convolutional cells."""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager

TOL = 1e-5
CPU = tmx.cpu()
B, T, C, H = 3, 4, 5, 6
PKGS = {"jax": (jmx, JNameManager), "port": (tmx, TNameManager)}


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _build(pkg, make):
    mx, nm = PKGS[pkg]
    with nm():
        return make(mx)


def _bind_run(mx, sym, values, heads, shapes):
    ctx = mx.cpu()
    ex = sym.simple_bind(ctx=ctx, **shapes)
    for name, v in values.items():
        ex.arg_dict[name][:] = mx.nd.array(v, ctx=ctx)
    ex.forward(is_train=True)
    outs = [o.asnumpy() for o in ex.outputs]
    ex.backward([mx.nd.array(h, ctx=ctx) for h in heads])
    grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()
             if g is not None}
    return outs, grads


def _values(sym, shapes, seed):
    rng = np.random.RandomState(seed)
    arg_shapes, out_shapes, _ = sym.infer_shape(**shapes)
    values = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)}
    heads = [rng.randn(*s).astype(np.float32) for s in out_shapes]
    return values, heads


def run_both(make, shapes, seed=0):
    """``make(mx)`` built and run in both packages; returns the port's
    symbol after checking lists, JSON, shapes, outputs and gradients."""
    jsym, tsym = _build("jax", make), _build("port", make)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.tojson() == jsym.tojson()
    jshapes = jsym.infer_shape(**shapes)
    tshapes = tsym.infer_shape(**shapes)
    for got, want in zip(tshapes, jshapes):
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
    values, heads = _values(jsym, shapes, seed)
    jouts, jgrads = _bind_run(jmx, jsym, values, heads, shapes)
    touts, tgrads = _bind_run(tmx, tsym, values, heads, shapes)
    assert len(touts) == len(jouts)
    for got, want in zip(touts, jouts):
        assert got.shape == want.shape
        _close(got, want)
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        _close(tgrads[k], jgrads[k])
    return tsym


def _unrolled(cell_fn, layout="NTC", merge=True, length=T):
    def make(mx):
        cell = cell_fn(mx)
        outs, states = cell.unroll(length, inputs=mx.sym.Variable("data"),
                                   layout=layout, merge_outputs=merge)
        outs = [outs] if merge else list(outs)
        return mx.sym.Group(outs + list(states))
    return make


def _stack(mx):
    s = mx.rnn.SequentialRNNCell()
    s.add(mx.rnn.LSTMCell(H, prefix="l0_"))
    s.add(mx.rnn.DropoutCell(0.0, prefix="d0_"))
    s.add(mx.rnn.GRUCell(H, prefix="l1_"))
    return s


CELLS = {
    "rnn_tanh": lambda mx: mx.rnn.RNNCell(H, prefix="r_"),
    "rnn_relu": lambda mx: mx.rnn.RNNCell(H, activation="relu",
                                          prefix="r_"),
    "lstm": lambda mx: mx.rnn.LSTMCell(H, prefix="l_", forget_bias=0.5),
    "gru": lambda mx: mx.rnn.GRUCell(H, prefix="g_"),
    "sequential": _stack,
    "residual": lambda mx: mx.rnn.ResidualCell(
        mx.rnn.GRUCell(C, prefix="rg_")),
    "zoneout": lambda mx: mx.rnn.ZoneoutCell(
        mx.rnn.LSTMCell(H, prefix="z_")),
    "bidirectional": lambda mx: mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(H, prefix="bl_"), mx.rnn.GRUCell(H, prefix="br_")),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_unroll_equals_jax(cell):
    run_both(_unrolled(CELLS[cell]), {"data": (B, T, C)})


@pytest.mark.parametrize("layout,merge", [("TNC", True), ("NTC", False)])
def test_unroll_layouts_and_lists(layout, merge):
    shape = (T, B, C) if layout == "TNC" else (B, T, C)
    run_both(_unrolled(CELLS["lstm"], layout, merge), {"data": shape})


def test_step_by_step_call_equals_unroll():
    """``cell(x, states)`` a step at a time builds the unroll's graph."""
    def make(mx):
        cell = mx.rnn.LSTMCell(H, prefix="s_")
        states = cell.begin_state()
        outs = []
        for x in mx.sym.SliceChannel(mx.sym.Variable("data"), axis=1,
                                     num_outputs=T, squeeze_axis=True):
            out, states = cell(x, states)
            outs.append(out)
        return mx.sym.Group(outs + states)
    run_both(make, {"data": (B, T, C)})


FUSED = [(mode, bidir) for mode in ("lstm", "gru", "rnn_tanh")
         for bidir in (False, True)]


@pytest.mark.parametrize("mode,bidir", FUSED)
def test_fused_cell_equals_jax(mode, bidir):
    """Two layers through the registered RNN op, NTC (SwapAxis on both
    sides of the time-major op), the next states returned."""
    def make(mx):
        cell = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                   bidirectional=bidir, get_next_state=True,
                                   prefix="f_")
        outs, states = cell.unroll(T, inputs=mx.sym.Variable("data"),
                                   merge_outputs=True)
        return mx.sym.Group([outs] + states)
    sym = run_both(make, {"data": (B, T, C)})
    if mode == "lstm":
        assert sym.list_arguments() == ["data", "f_parameters"]


def _vector(mode, bidir, seed=3):
    cell = tmx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                bidirectional=bidir, prefix="f_")
    size = tmx.ops.rnn.rnn_param_size(2, C, H, bidir, mode)
    vec = np.random.RandomState(seed).uniform(-0.5, 0.5, size)
    return cell, vec.astype(np.float32)


@pytest.mark.parametrize("mode,bidir", FUSED)
def test_unpack_and_pack_weights_equal_jax(mode, bidir):
    cell, vec = _vector(mode, bidir)
    jcell = jmx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                 bidirectional=bidir, prefix="f_")
    got = cell.unpack_weights({"f_parameters": tmx.nd.array(vec, ctx=CPU),
                               "other": tmx.nd.array([1.0], ctx=CPU)})
    want = jcell.unpack_weights({"f_parameters": jmx.nd.array(vec),
                                 "other": jmx.nd.array([1.0])})
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    back = cell.pack_weights(got)
    np.testing.assert_array_equal(back["f_parameters"].asnumpy(), vec)
    # the unfused stack's own packed names, and back again
    stack = cell.unfuse()
    packed = stack.pack_weights(dict(got))
    jpacked = jcell.unfuse().pack_weights(dict(want))
    assert sorted(packed) == sorted(jpacked)
    for k in jpacked:
        np.testing.assert_array_equal(packed[k].asnumpy(),
                                      jpacked[k].asnumpy())
    again = cell.pack_weights(stack.unpack_weights(packed))
    np.testing.assert_array_equal(again["f_parameters"].asnumpy(), vec)


@pytest.mark.parametrize("mode,bidir", FUSED)
def test_unfuse_runs_as_the_fused_cell(mode, bidir):
    """The fused cell and its unfused stack, weights carried through
    unpack_weights and the stack's pack_weights, give the same outputs."""
    cell, vec = _vector(mode, bidir, seed=5)
    stack = cell.unfuse()
    x = np.random.RandomState(6).randn(B, T, C).astype(np.float32)
    fused = {"f_parameters": tmx.nd.array(vec, ctx=CPU)}
    outs = []
    for c, args in ((cell, fused),
                    (stack, stack.pack_weights(cell.unpack_weights(fused)))):
        out, _ = c.unroll(T, inputs=tmx.sym.Variable("data"),
                          merge_outputs=True)
        ex = out.simple_bind(CPU, grad_req="null", data=x.shape)
        for name, v in dict(args, data=tmx.nd.array(x, ctx=CPU)).items():
            ex.arg_dict[name][:] = v
        outs.append(ex.forward()[0].asnumpy())
    _close(outs[1], outs[0])


def test_begin_state_zeros_and_variable():
    cell = tmx.rnn.LSTMCell(H, prefix="b_")
    zeros = cell.begin_state()
    assert [s.name for s in zeros] == ["b_begin_state_0", "b_begin_state_1"]
    assert zeros[0].list_arguments() == []
    assert zeros[0].infer_shape()[1] == [(1, H)]
    variables = cell.begin_state(func=tmx.sym.Variable)
    assert [s.name for s in variables] == ["b_begin_state_2",
                                           "b_begin_state_3"]
    assert variables[0].attr("__shape__") == str((0, H))
    fused = tmx.rnn.FusedRNNCell(H, num_layers=2, bidirectional=True)
    assert fused.state_shape == [(4, 0, H), (4, 0, H)]
    assert fused.begin_state()[0].infer_shape()[1] == [(4, 1, H)]


def _variable_states(mx):
    cell = mx.rnn.LSTMCell(H, prefix="v_")
    outs, states = cell.unroll(T, inputs=mx.sym.Variable("data"),
                               begin_state=cell.begin_state(
                                   func=mx.sym.Variable),
                               merge_outputs=True)
    return mx.sym.Group([outs] + states)


def test_partial_shapes_solve_a_zero_batch():
    """A Variable begin state of shape (0, H) is solved to (B, H) from the
    data through FullyConnected, elemwise and SliceChannel, forward and
    backward, as the JAX package solves it; then the cell runs."""
    jsym, tsym = _build("jax", _variable_states), \
        _build("port", _variable_states)
    got = tsym.infer_shape(data=(B, T, C))
    want = jsym.infer_shape(data=(B, T, C))
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in want[0]]
    assert dict(zip(tsym.list_arguments(), got[0]))["v_begin_state_1"] == \
        (B, H)
    assert got[1] == [tuple(s) for s in want[1]]
    run_both(_variable_states, {"data": (B, T, C)}, seed=2)
    # a shape given with a 0 batch is solved the same way
    part = tsym.infer_shape(data=(B, T, C), v_begin_state_0=(0, H))
    assert part[0] == got[0]
    # without the data, the batch stays unknown
    arg_shapes, outs, _ = tsym.infer_shape_partial()
    assert outs is None and dict(zip(tsym.list_arguments(),
                                     arg_shapes))["v_begin_state_0"] is None


def test_partial_shapes_of_a_convolution_and_concat():
    def make(mx):
        h = mx.sym.Variable("h", shape=(0, 2, 0, 0))
        conv = mx.sym.Convolution(mx.sym.Variable("x"), kernel=(3, 3),
                                  pad=(1, 1), num_filter=2, name="c")
        both = mx.sym.Concat(conv + h, mx.sym.Variable("y"), dim=1)
        return mx.sym.FullyConnected(mx.sym.Flatten(both), num_hidden=3,
                                     name="fc")
    jsym, tsym = _build("jax", make), _build("port", make)
    shapes = {"x": (2, 1, 5, 5), "y": (2, 3, 5, 5)}
    got, want = tsym.infer_shape(**shapes), jsym.infer_shape(**shapes)
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in want[0]]
    assert dict(zip(tsym.list_arguments(), got[0]))["h"] == (2, 2, 5, 5)
    with pytest.raises(MXNetError):
        tsym.infer_shape(x=(2, 1, 5, 5), y=(2, 3, 5, 5), h=(3, 2, 5, 5))


def test_swapaxis_and_rnn_shape_rule():
    def make(mx):
        data = mx.sym.SwapAxis(mx.sym.Variable("data"), dim1=0, dim2=1)
        return mx.sym.RNN(data=data, state_size=H, num_layers=2,
                          mode="lstm", bidirectional=True,
                          state_outputs=True, name="rnn")
    jsym, tsym = _build("jax", make), _build("port", make)
    assert tsym.list_arguments() == ["data", "rnn_parameters", "rnn_state",
                                     "rnn_state_cell"]
    got = tsym.infer_shape(data=(B, T, C))
    want = jsym.infer_shape(data=(B, T, C))
    for g, w in zip(got, want):
        assert [tuple(s) for s in g] == [tuple(s) for s in w]
    assert got[0][1] == (tmx.ops.rnn.rnn_param_size(2, C, H, True, "lstm"),)
    assert got[0][2] == (4, B, H)
    assert got[1] == [(T, B, 2 * H), (4, B, H), (4, B, H)]
    assert tmx.sym.swapaxes is tmx.sym.SwapAxis
    run_both(make, {"data": (B, T, C)})


def _init_by_attribute(mx, init, name, shape, ctx):
    """An array filled as a Module fills a variable whose ``__init__``
    attribute is ``init``'s (the global initializer not consulted but for
    FusedRNN's weights)."""
    arr = mx.nd.zeros(shape, ctx=ctx)
    desc = mx.init.InitDesc(name, {"__init__": init.dumps()})
    mx.init.Uniform(0.3)(desc, arr)
    return arr.asnumpy()


def test_lstm_bias_and_fused_rnn_init_equal_jax():
    """LSTMBias writes the forget gate's quarter; FusedRNN fills every
    piece of the packed vector: weights by its ``init``, biases 0, the
    LSTM's forget biases ``forget_bias``; both equal to the JAX
    package's, reached through the ``__init__`` attribute."""
    got = _init_by_attribute(tmx, tmx.init.LSTMBias(0.7), "l_i2h_bias",
                             (4 * H,), CPU)
    want = _init_by_attribute(jmx, jmx.init.LSTMBias(0.7), "l_i2h_bias",
                              (4 * H,), jmx.cpu())
    np.testing.assert_array_equal(got, want)
    assert set(got[H:2 * H]) == {np.float32(0.7)}
    for mode, bidir in FUSED:
        size = tmx.ops.rnn.rnn_param_size(2, C, H, bidir, mode)
        args = (H, 2, mode, bidir, 0.5)
        got = _init_by_attribute(
            tmx, tmx.init.FusedRNN(tmx.init.Constant(0.25), *args),
            "f_parameters", (size,), CPU)
        want = _init_by_attribute(
            jmx, jmx.init.FusedRNN(jmx.init.Constant(0.25), *args),
            "f_parameters", (size,), jmx.cpu())
        np.testing.assert_array_equal(got, want)
        expect = {0.0, 0.25} | ({0.5} if mode == "lstm" else set())
        assert set(np.unique(got)) == expect


def test_cells_initialise_through_their_attributes():
    """A Module's initializer reaches the cells' own initializers: the
    LSTM's i2h bias through LSTMBias, the fused vector through FusedRNN
    with the Module's initializer for its weights (Xavier's bound of each
    piece's own fan-in)."""
    for make, shape in (
            (lambda mx: mx.rnn.LSTMCell(H, prefix="l_"), None),
            (lambda mx: mx.rnn.FusedRNNCell(H, num_layers=2, prefix="f_"),
             None)):
        cell = make(tmx)
        out, _ = cell.unroll(T, inputs=tmx.sym.Variable("data"),
                             merge_outputs=True)
        mod = tmx.mod.Module(out, data_names=["data"], label_names=None,
                             context=CPU)
        mod.bind([("data", (B, T, C))], for_training=False)
        tmx.random.seed(1)
        mod.init_params(tmx.init.Xavier(factor_type="in", magnitude=2.34))
        args = mod.get_params()[0]
        if isinstance(cell, tmx.rnn.LSTMCell):
            bias = args["l_i2h_bias"].asnumpy()
            np.testing.assert_array_equal(
                bias, np.repeat([0.0, 1.0, 0.0, 0.0], H).astype(np.float32))
            pieces = {"l_i2h_weight": args["l_i2h_weight"].asnumpy()}
        else:
            pieces = {k: v.asnumpy() for k, v in cell.unpack_weights(
                args).items()}
        for name, v in pieces.items():
            if name.endswith("weight"):
                bound = np.sqrt(2.34 / v.shape[1])
                assert np.abs(v).max() <= bound
                assert np.abs(v).max() > 0.5 * bound
            elif name.endswith("_f_bias"):
                assert (v == 1.0).all()
            else:
                assert (v == 0.0).all()


def test_xavier_law_equals_jax():
    """Xavier(factor_type="in", magnitude=2.34) draws U(-s, s), s =
    sqrt(2.34 / fan_in), in both packages (the draws differ: numpy
    against JAX's keys)."""
    shape = (400, 50)
    bound = np.sqrt(2.34 / 50)
    t = tmx.nd.zeros(shape, ctx=CPU)
    j = jmx.nd.zeros(shape)
    tmx.random.seed(0)
    tmx.init.Xavier(factor_type="in", magnitude=2.34)("w_weight", t)
    jmx.init.Xavier(factor_type="in", magnitude=2.34)("w_weight", j)
    for v in (t.asnumpy(), j.asnumpy()):
        assert np.abs(v).max() <= bound
        assert abs(v.std() - bound / np.sqrt(3)) < 0.02 * bound
        assert abs(v.mean()) < 0.02 * bound


CONV = {
    "conv_rnn": lambda mx: mx.rnn.ConvRNNCell((B, 2, 5, 5), 3,
                                              prefix="cr_"),
    "conv_lstm": lambda mx: mx.rnn.ConvLSTMCell((B, 2, 5, 5), 3,
                                                prefix="cl_"),
    "conv_gru": lambda mx: mx.rnn.ConvGRUCell(
        (B, 2, 5, 5), 3, i2h_kernel=(3, 3), i2h_pad=(0, 0), prefix="cg_"),
}


@pytest.mark.parametrize("cell", sorted(CONV))
def test_conv_cells_equal_jax(cell):
    """Three steps over NCHW maps: Convolution i2h and h2h (K1 on the
    card), LeakyReLU, the gates sliced along the channels."""
    run_both(_unrolled(CONV[cell], length=3), {"data": (B, 3, 2, 5, 5)})


def test_conv_cell_state_shape_and_errors():
    cell = tmx.rnn.ConvGRUCell((B, 2, 5, 5), 3, i2h_pad=(0, 0))
    assert cell.state_shape == [(0, 3, 3, 3)]
    with pytest.raises(MXNetError):
        tmx.rnn.ConvLSTMCell((B, 2, 5, 5), 3, h2h_kernel=(2, 2))
    with pytest.raises(MXNetError):
        tmx.rnn.ZoneoutCell(tmx.rnn.FusedRNNCell(H))
    with pytest.raises(MXNetError):
        tmx.rnn.FusedRNNCell(H)(tmx.sym.Variable("x"), [])
    inner = tmx.rnn.LSTMCell(H)
    tmx.rnn.ResidualCell(inner)
    with pytest.raises(MXNetError):
        inner.begin_state()


def test_zoneout_in_train_mode_keeps_new_or_old():
    """With zoneout the next state is, element by element, the new state
    or the one before (the masks are the port's own draws)."""
    cell = tmx.rnn.ZoneoutCell(tmx.rnn.RNNCell(H, prefix="z_"),
                               zoneout_states=0.5)
    states = cell.begin_state(func=tmx.sym.Variable)
    out, nxt = cell(tmx.sym.Variable("x"), states)
    base = tmx.rnn.RNNCell(H, prefix="z_")
    plain, _ = base(tmx.sym.Variable("x"), states)
    rng = np.random.RandomState(0)
    args = {"x": rng.randn(B, C), "z_begin_state_0": rng.randn(B, H),
            "z_i2h_weight": rng.randn(H, C), "z_i2h_bias": rng.randn(H),
            "z_h2h_weight": rng.randn(H, H), "z_h2h_bias": rng.randn(H)}
    args = {k: tmx.nd.array(v, ctx=CPU) for k, v in args.items()}
    new = plain.bind(CPU, args, grad_req="null").forward()[0].asnumpy()
    ex = tmx.sym.Group([out] + nxt).bind(CPU, args, grad_req="null")
    got = ex.forward(is_train=True)[1].asnumpy()
    old = args["z_begin_state_0"].asnumpy()
    assert np.all((got == new) | (got == old))
    assert (got == new).any() and (got == old).any()
