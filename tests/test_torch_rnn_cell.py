"""The port's recurrent cells against the JAX package's, through
``unroll``, on the CPU (after ``tests/test_gluon_rnn.py``).

Every cell of ``gluon/rnn/rnn_cell.py`` -- RNNCell (tanh, relu),
LSTMCell, GRUCell, SequentialRNNCell, HybridSequentialRNNCell,
ResidualCell, ZoneoutCell and BidirectionalCell
-- with a deferred input width, the JAX cell initialised and unrolled
once, its weights carried by ``load_mxnet_tpu_params``; then both
unrolled in NTC and TNC, with merged and list outputs, with and without
``valid_length``, recorded in predict mode (the dropout and zoneout
cells pass their inputs through).  Outputs and states within 1e-5
(absolute, scaled by the largest magnitude when it exceeds 1), parameter
gradients within 1e-4.  Also the port's fused LSTM and GRU layers against
its own LSTMCell and GRUCell (as ``tests/test_gluon_rnn.py:37-72``), the
dropout and zoneout cells in train mode, and the cells' errors.

The DropoutCell is held to its laws and to the stack without it, not to
the JAX package: there a predict-mode Dropout hands back its input
unrecorded, and the gradients of the cells before it lose the outputs'
share (a stack with a DropoutCell gets other gradients than the same
stack without one, outputs equal).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgl
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon import rnn as trnn

N, T, C, H = 3, 5, 4, 6
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
VALID = np.array([5, 2, 4], np.float32)


def _build(pkg, name, device):
    """The cell ``name`` from ``pkg`` (the JAX or the port's gluon.rnn)."""
    kw = {} if device is None else {"device": device}
    if name == "rnn_tanh":
        return pkg.RNNCell(H, "tanh", **kw)
    if name == "rnn_relu":
        return pkg.RNNCell(H, "relu", **kw)
    if name in ("lstm", "gru"):
        return (pkg.LSTMCell if name == "lstm" else pkg.GRUCell)(H, **kw)
    if name in ("sequential", "hybrid_sequential"):
        stack = pkg.SequentialRNNCell() if name == "sequential" \
            else pkg.HybridSequentialRNNCell()
        stack.add(pkg.LSTMCell(H, **kw))
        stack.add(pkg.GRUCell(H, **kw))
        return stack
    if name == "residual":
        return pkg.ResidualCell(pkg.GRUCell(C, **kw))
    if name == "zoneout":
        return pkg.ZoneoutCell(pkg.LSTMCell(H, **kw), 0.5, 0.5)
    assert name == "bidirectional"
    return pkg.BidirectionalCell(pkg.LSTMCell(H, **kw), pkg.GRUCell(H, **kw))


CELLS = ["rnn_tanh", "rnn_relu", "lstm", "gru", "sequential",
         "hybrid_sequential", "residual", "zoneout", "bidirectional"]
UNROLLS = [("NTC", True, False), ("TNC", False, False), ("NTC", None, True),
           ("TNC", False, True)]


def _pair(name, seed):
    mx.random.seed(seed)
    jcell = _build(jgl.rnn, name, None)
    jcell.initialize(mx.init.Uniform(0.4))
    jcell.unroll(T, mx.nd.array(np.zeros((N, T, C), np.float32)),
                 layout="NTC")  # finish the deferred shapes
    params = {k: p.data().asnumpy()
              for k, p in jcell._collect_params_with_prefix().items()}
    tcell = _build(trnn, name, "cpu")
    assert list(tcell._collect_params_with_prefix()) == list(params)
    return jcell, load_mxnet_tpu_params(tcell, params)


def _flat(outputs, states):
    outs = outputs if isinstance(outputs, list) else [outputs]
    return outs + list(states)


def _close(got, want, tol, what=""):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("layout,merge,valid", UNROLLS,
                         ids=["ntc-merged", "tnc-list", "ntc-valid",
                              "tnc-list-valid"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_unroll_matches_jax(name, layout, merge, valid):
    jcell, tcell = _pair(name, seed=CELLS.index(name))
    rng = np.random.RandomState(CELLS.index(name) + 20)
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    x = rng.randn(*shape).astype(np.float32)
    kw = dict(layout=layout, merge_outputs=merge)
    with jag.record(train_mode=False):
        jouts, jstates = jcell.unroll(
            T, mx.nd.array(x), valid_length=mx.nd.array(VALID)
            if valid else None, **kw)
        jflat = _flat(jouts, jstates)
        jloss = sum((o * o).sum() for o in jflat)
    jloss.backward()
    with autograd.record(train_mode=False):
        touts, tstates = tcell.unroll(
            T, torch.from_numpy(x), valid_length=torch.from_numpy(VALID)
            if valid else None, **kw)
        tflat = _flat(touts, tstates)
        tloss = sum((o * o).sum() for o in tflat)
    autograd.backward(tloss)
    assert isinstance(touts, list) == isinstance(jouts, list)
    assert len(tflat) == len(jflat)
    for i, (g, w) in enumerate(zip(tflat, jflat)):
        assert tuple(g.shape) == w.shape
        _close(g.detach().numpy(), w.asnumpy(), OUT_TOL, "output %d" % i)
    want = {k: p.grad().asnumpy()
            for k, p in jcell._collect_params_with_prefix().items()}
    for k, p in tcell._collect_params_with_prefix().items():
        _close(p.grad.numpy(), want[k], GRAD_TOL, k)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_fused_layer_matches_cell(kind):
    """The fused layer's recurrence equals its cell unrolled step by
    step, with the layer's weights copied into the cell."""
    layer = (trnn.LSTM if kind == "lstm" else trnn.GRU)(
        H, input_size=C, device="cpu").initialize(tmx.init.Uniform(0.5))
    cell = (trnn.LSTMCell if kind == "lstm" else trnn.GRUCell)(
        H, input_size=C, device="cpu")
    load_mxnet_tpu_params(cell, {
        k[3:]: v.detach().numpy()
        for k, v in layer._collect_params_with_prefix().items()})
    x = torch.from_numpy(np.random.RandomState(1).rand(T, N, C)
                         .astype(np.float32))
    outs, states = cell.unroll(T, x, layout="TNC", merge_outputs=True)
    out, last = layer(x, layer.begin_state(N))
    np.testing.assert_allclose(out.detach().numpy(),
                               outs.detach().numpy(), rtol=1e-4, atol=1e-5)
    for a, b in zip(last, states):
        np.testing.assert_allclose(a[0].detach().numpy(),
                                   b.detach().numpy(), rtol=1e-4, atol=1e-5)


def test_dropout_and_zoneout_cells_in_train_mode():
    """DropoutCell keeps about 1 - rate of its inputs, scaled; ZoneoutCell
    takes each unit from the new output or the previous one."""
    tmx.random.seed(3)
    drop = trnn.DropoutCell(0.5)
    x = torch.ones(200, 100)
    with autograd.train_mode():
        out, st = drop(x, [])
    assert st == [] and set(np.unique(out.numpy())) == {0.0, 2.0}
    assert abs(float((out > 0).float().mean()) - 0.5) < 0.02
    assert torch.equal(drop(x, [])[0], x)  # predict mode
    # in predict mode a stack with a DropoutCell records the same
    # outputs and gradients as without it
    grads = []
    for with_drop in (False, True):
        stack = trnn.SequentialRNNCell()
        stack.add(trnn.LSTMCell(H, input_size=C, device="cpu"))
        if with_drop:
            stack.add(trnn.DropoutCell(0.5))
        stack.add(trnn.GRUCell(H, input_size=H, device="cpu"))
        stack.initialize(seed=4)
        with autograd.record(train_mode=False):
            outs, _ = stack.unroll(T, torch.ones(N, T, C),
                                   merge_outputs=True)
        autograd.backward((outs * outs).sum())
        grads.append([p.grad for p in
                      stack._collect_params_with_prefix().values()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    base = trnn.GRUCell(H, input_size=C, device="cpu").initialize()
    zone = trnn.ZoneoutCell(base, zoneout_outputs=0.5)
    xs = torch.randn(N, T, C)
    with autograd.train_mode():
        outs, _ = zone.unroll(T, xs, merge_outputs=False)
    base._modified = False
    plain, _ = base.unroll(T, xs, merge_outputs=False)
    base._modified = True
    prev = torch.zeros_like(outs[0])
    for o, p in zip(outs, plain):
        assert bool(((o == p) | (o == prev)).all())
        prev = o


def test_cell_errors_and_hybridized_step():
    base = trnn.LSTMCell(H, input_size=C, device="cpu").initialize()
    res = trnn.ResidualCell(base)
    with pytest.raises(tmx.MXNetError):
        base.begin_state(N)  # wrapped: the modifier's begin_state
    assert len(res.begin_state(N)) == 2
    bi = trnn.BidirectionalCell(
        trnn.LSTMCell(H, input_size=C, device="cpu").initialize(),
        trnn.LSTMCell(H, input_size=C, device="cpu").initialize())
    with pytest.raises(NotImplementedError):
        bi(torch.ones(N, C), bi.begin_state(N))
    stack = trnn.SequentialRNNCell()
    stack.add(bi)
    with pytest.raises(tmx.MXNetError):
        stack(torch.ones(N, C), stack.begin_state(N))
    with pytest.raises(tmx.MXNetError):
        trnn.GRUCell(H, params={}, device="cpu")
    # a hybridized stack takes its states as a list, one cache entry
    hs = trnn.HybridSequentialRNNCell()
    hs.add(trnn.GRUCell(H, device="cpu"))
    hs.add(trnn.LSTMCell(H, device="cpu"))
    hs.initialize()
    hs.hybridize()
    states = hs.begin_state(N, device="cpu")
    out, states = hs(torch.ones(N, C), states)
    out2, states = hs(torch.ones(N, C), states)
    assert len(hs._cached_graphs) == 1 and len(states) == 3
    assert tuple(out2.shape) == (N, H) and not torch.equal(out, out2)


def _prefixes(pkg):
    """The prefixes of a sequence of recurrent layers and cells made in a
    fresh scope (whose counters start at 0, as the process-wide ones do),
    and of a stack's cells: each named by its alias, one counter per alias
    shared by the layers and the cells."""
    g = pkg.gluon.rnn
    holder = pkg.gluon.Block(prefix="model_")
    with holder.name_scope():
        blocks = [g.LSTM(4), g.LSTMCell(4), g.GRUCell(4), g.RNN(3),
                  g.RNN(3, activation="tanh"), g.RNNCell(3),
                  g.DropoutCell(0.5)]
        seq = g.SequentialRNNCell()
        with seq.name_scope():
            seq.add(g.LSTMCell(3))
            seq.add(g.GRUCell(3))
        blocks += [seq] + list(seq)
        blocks += [g.ZoneoutCell(g.GRUCell(3)),
                   g.ResidualCell(g.LSTMCell(3))]
    return [b.prefix for b in blocks] + list(blocks[1].collect_params())


def test_cell_prefixes_equal_jax():
    with tmx.cpu():
        got = _prefixes(tmx)
    assert got == _prefixes(mx)
