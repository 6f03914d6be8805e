"""The port's RNN op, its fused RNN/LSTM/GRU layers and the word language
model against the JAX package's, on the CPU.

- The registered ``RNN`` against the JAX op on the same seeded inputs:
  {lstm, gru, rnn_tanh, rnn_relu} x {1, 2 layers} x {uni-, bidirectional},
  the cell state clipped every step, and a batch-1 state.  Outputs and
  final states within 1e-5 (absolute, scaled by the largest magnitude
  when it exceeds 1; float32 sums of the two libraries run in other
  orders); gradients of every input against ``jax.grad`` within 1e-4.
- The op's inter-layer dropout: the kept share at p = 0.5 within 0.01
  of 0.5 (64000 draws: 8 standard deviations), nothing dropped in
  predict mode, another mask on each call.
- The layers against the JAX layers (weights carried by
  ``load_mxnet_tpu_params``), TNC and NTC, with and without states:
  outputs, states and parameter gradients within 1e-5 / 1e-4; the
  structural parameter names and their order equal the JAX package's.
- The word LM at a small size (vocab 200, embedding 32, hidden 64, 2
  layers, bptt 8, batch 4, dropout 0): 3 steps of the loop of
  ``example/rnn/word_lm/train.py`` with ``clip_global_norm`` (clipping in
  every step) and SGD at lr 1, the loss summed over the steps and
  averaged over the batch (``PTB_MEDIUM``'s convention): each step's
  mean loss and clip norm within 1e-4 relative, the final parameters
  within 1e-4 absolute.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgl
from mxnet_tpu.ops import rnn as jrnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.model_zoo import word_lm
from mxnet_tpu_torch.ops import rnn as top

T, B, I, H = 5, 3, 4, 6
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
OP_CASES = [(mode, layers, bi) for mode in ("lstm", "gru", "rnn_tanh",
                                            "rnn_relu")
            for layers in (1, 2) for bi in (False, True)]


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _op_inputs(mode, layers, bi, seed, batch1=False):
    rng = np.random.RandomState(seed)
    dirs = 2 if bi else 1
    n = jrnn.rnn_param_size(layers, I, H, bi, mode)
    assert n == top.rnn_param_size(layers, I, H, bi, mode)
    sb = 1 if batch1 else B
    arrays = [rng.randn(T, B, I).astype(np.float32),
              rng.uniform(-0.5, 0.5, n).astype(np.float32),
              (0.5 * rng.randn(layers * dirs, sb, H)).astype(np.float32)]
    if mode == "lstm":
        arrays.append((0.5 * rng.randn(layers * dirs, sb, H))
                      .astype(np.float32))
    return arrays


def _check_op(mode, layers, bi, seed, batch1=False, **clip):
    arrays = _op_inputs(mode, layers, bi, seed, batch1)
    attrs = dict(state_size=H, num_layers=layers, bidirectional=bi,
                 mode=mode, state_outputs=True, **clip)
    rng = np.random.RandomState(seed + 1)

    def jax_loss(*args):
        outs = jrnn.rnn(None, *args, **attrs)
        return sum((o * c).sum() for o, c in zip(outs, couts)), outs

    want = jrnn.rnn(None, *[jnp.asarray(a) for a in arrays], **attrs)
    couts = [jnp.asarray(rng.randn(*o.shape).astype(np.float32))
             for o in want]
    want_grads = jax.grad(lambda *a: jax_loss(*a)[0],
                          argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])

    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    got = top.rnn(*ts, **attrs)
    assert len(got) == len(want) == (3 if mode == "lstm" else 2)
    for g, w, name in zip(got, want, ("out", "h", "c")):
        _close(g.detach().numpy(), w, OUT_TOL, name)
    torch.autograd.backward(list(got), [torch.from_numpy(np.array(c))
                                        for c in couts])
    for t, w, name in zip(ts, want_grads, ("data", "parameters", "state",
                                           "state_cell")):
        _close(t.grad.numpy(), w, GRAD_TOL, "d" + name)


@pytest.mark.parametrize("mode,layers,bi", OP_CASES)
def test_rnn_op_matches_jax(mode, layers, bi):
    _check_op(mode, layers, bi, seed=len(mode) * 10 + layers * 2 + bi)


@pytest.mark.parametrize("case", ["clip", "batch1", "clip-batch1"])
def test_rnn_op_clip_and_batch1_state_match_jax(case):
    clip = dict(lstm_state_clip_min=-0.25, lstm_state_clip_max=0.3) \
        if "clip" in case else {}
    _check_op("lstm", 2, True, seed=3, batch1="batch1" in case, **clip)


def test_nd_rnn_and_packed_layout():
    """mx.nd.RNN on NDArrays (three outputs with state_outputs, one
    without) equals the unpacked core on the views :func:`unpack` makes,
    and a packed vector of the wrong length raises."""
    arrays = _op_inputs("lstm", 2, False, seed=11)
    nds = [tmx.nd.array(a, ctx=tmx.cpu()) for a in arrays]
    outs = tmx.nd.RNN(*nds, state_size=H, num_layers=2, mode="lstm",
                      state_outputs=True)
    assert len(outs) == 3
    only = tmx.nd.RNN(*nds, state_size=H, num_layers=2, mode="lstm")
    np.testing.assert_array_equal(only.asnumpy(), outs[0].asnumpy())
    t = [torch.from_numpy(a) for a in arrays]
    ws = top.unpack(t[1], 2, I, H, 1, 4)
    assert [tuple(w.shape) for w in ws[1]] == [(24, 6), (24, 6), (24,),
                                               (24,)]
    out, h, c = top.rnn_forward(t[0], ws, t[2], t[3], num_layers=2)
    for g, w in zip((out, h, c), outs):
        np.testing.assert_array_equal(g.numpy(), w.asnumpy())
    with pytest.raises(tmx.MXNetError):
        top.rnn(t[0], t[1][:-1], t[2], t[3], state_size=H, num_layers=2)


def test_rnn_op_dropout_rate():
    """Between layers only, in train mode only: with layer 0 giving ones
    and layer 1 the identity (relu, W_i2h = I, no recurrence), the output
    is the mask over 1 - p."""
    tb, hh, p = 50, 64, 0.5
    ws = [(torch.zeros(hh, 3), torch.zeros(hh, hh), torch.ones(hh),
           torch.zeros(hh)),
          (torch.eye(hh), torch.zeros(hh, hh), torch.zeros(hh),
           torch.zeros(hh))]
    x = torch.randn(tb, 20, 3)
    h0 = torch.zeros(2, 20, hh)
    tmx.random.seed(5)
    outs = [top.rnn_forward(x, ws, h0, mode="rnn_relu", num_layers=2, p=p,
                            training=True)[0] for _ in range(2)]
    for out in outs:
        assert set(np.unique(out.numpy())) == {0.0, 2.0}
        assert abs(float((out > 0).float().mean()) - (1 - p)) < 0.01
    assert not torch.equal(outs[0], outs[1])
    still = top.rnn_forward(x, ws, h0, mode="rnn_relu", num_layers=2, p=p,
                            training=False)[0]
    assert torch.equal(still, torch.ones_like(still))
    # the registered op drops in train mode only, as the JAX dispatch
    packed = torch.cat([w.reshape(-1) for w in (ws[0][0], ws[0][1],
                                                ws[1][0], ws[1][1])]
                       + [b for w in ws for b in w[2:]])
    assert torch.equal(top.rnn(x, packed, h0, state_size=hh, num_layers=2,
                               mode="rnn_relu", p=p), still)
    with autograd.train_mode():
        dropped = top.rnn(x, packed, h0, state_size=hh, num_layers=2,
                          mode="rnn_relu", p=p)
    assert abs(float((dropped > 0).float().mean()) - (1 - p)) < 0.01


LAYERS = [("LSTM", {}), ("GRU", {}), ("RNN", {"activation": "tanh"}),
          ("RNN", {"activation": "relu"})]


def _layer_pair(cls, kw, layers, bi, layout, seed):
    """A JAX layer with a deferred input width, initialised and run once,
    and the port's (deferred too) carrying its weights."""
    mx.random.seed(seed)
    jl = getattr(jgl.rnn, cls)(H, layers, layout=layout, bidirectional=bi,
                               **kw)
    jl.initialize(mx.init.Uniform(0.3))
    shape = (T, B, I) if layout == "TNC" else (B, T, I)
    jl(mx.nd.array(np.zeros(shape, np.float32)))
    params = {k: p.data().asnumpy()
              for k, p in jl._collect_params_with_prefix().items()}
    tl = getattr(trnn, cls)(H, layers, layout=layout, bidirectional=bi,
                            device="cpu", **kw)
    assert list(tl.collect_params()) == list(params)
    return jl, load_mxnet_tpu_params(tl, params)


@pytest.mark.parametrize("cls,kw", LAYERS,
                         ids=["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("with_states", [False, True])
def test_layers_match_jax(cls, kw, layout, with_states):
    layers, bi = 2, cls != "RNN" or layout == "NTC"
    jl, tl = _layer_pair(cls, kw, layers, bi, layout, seed=4)
    rng = np.random.RandomState(8)
    shape = (T, B, I) if layout == "TNC" else (B, T, I)
    x = rng.randn(*shape).astype(np.float32)
    states = [(0.5 * rng.randn(layers * (1 + bi), B, H)).astype(np.float32)
              for _ in jl.state_info(B)]
    with jag.record():
        jout = jl(mx.nd.array(x), [mx.nd.array(s) for s in states]) \
            if with_states else jl(mx.nd.array(x))
        outs = list(jout) if with_states else [jout]
        flat = [outs[0]] + (list(outs[1]) if with_states else [])
        jloss = sum((o * o).sum() for o in flat)
    jloss.backward()
    with autograd.record():
        tout = tl(torch.from_numpy(x), [torch.from_numpy(s)
                                        for s in states]) \
            if with_states else tl(torch.from_numpy(x))
        touts = list(tout) if with_states else [tout]
        tflat = [touts[0]] + (list(touts[1]) if with_states else [])
        tloss = sum((o * o).sum() for o in tflat)
    autograd.backward(tloss)
    assert len(tflat) == len(flat)
    for g, w in zip(tflat, flat):
        _close(g.detach().numpy(), w.asnumpy(), OUT_TOL)
    want = {k: p.grad().asnumpy()
            for k, p in jl._collect_params_with_prefix().items()}
    for name, p in tl.collect_params().items():
        _close(p.grad.numpy(), want[name], GRAD_TOL, name)


def test_layer_names_states_and_repr():
    """The JAX package's names (l0_i2h_weight ... r1_h2h_bias, in its
    order), begin_state on the layer's device, a lone tensor as the GRU's
    state, and the output width of a bidirectional layer."""
    jl = jgl.rnn.LSTM(H, 2, bidirectional=True, input_size=I)
    tl = trnn.LSTM(H, 2, bidirectional=True, input_size=I, device="cpu")
    assert list(tl.collect_params()) == list(jl._collect_params_with_prefix())
    assert list(tl.collect_params())[:5] == [
        "l0_i2h_weight", "l0_h2h_weight", "l0_i2h_bias", "l0_h2h_bias",
        "r0_i2h_weight"]
    states = tl.begin_state(B)
    assert [tuple(s.shape) for s in states] == [(4, B, H)] * 2
    assert all(s.device.type == "cpu" and not s.any() for s in states)
    assert [i["shape"] for i in tl.state_info(B)] \
        == [i["shape"] for i in jl.state_info(B)]
    gru = trnn.GRU(H, input_size=I, device="cpu").initialize()
    out, st = gru(torch.ones(T, B, I), torch.zeros(1, B, H))
    assert tuple(out.shape) == (T, B, H) and len(st) == 1
    tl.initialize()
    assert tuple(tl(torch.ones(T, B, I)).shape) == (T, B, 2 * H)
    assert repr(tl) == "LSTM(TNC, 2 layers, hidden=6, bidirectional)"


# -------------------------------------------------------------- word LM

V, E, HID, NL, BPTT, BATCH, STEPS, CLIP = 200, 32, 64, 2, 8, 4, 3, 1.0


def _example_model():
    path = os.path.join(os.path.dirname(__file__), "..", "example", "rnn",
                        "word_lm", "train.py")
    spec = importlib.util.spec_from_file_location("_word_lm_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.RNNModel


def test_word_lm_trajectory_matches_jax():
    corpus, _ = word_lm.synthetic_corpus(num_tokens=2000, vocab=V)
    data = word_lm.batchify(corpus, BATCH)
    batches = [(data[i:i + BPTT], data[i + 1:i + 1 + BPTT])
               for i in range(0, STEPS * BPTT, BPTT)]
    mx.random.seed(2)
    jm = _example_model()(V, E, HID, NL, dropout=0.0)
    jm.initialize(mx.init.Uniform(0.05))
    jm(mx.nd.array(batches[0][0]), jm.begin_state(func=mx.nd.zeros,
                                                   batch_size=BATCH))
    params = {k: p.data().asnumpy()
              for k, p in jm._collect_params_with_prefix().items()}
    jtrainer = jgl.Trainer(jm.collect_params(), "sgd",
                           {"learning_rate": 1.0})
    jloss_fn = jgl.loss.SoftmaxCrossEntropyLoss()
    hidden = jm.begin_state(func=mx.nd.zeros, batch_size=BATCH)
    want = []
    for x, y in batches:
        hidden = [h.detach() for h in hidden]
        with jag.record():
            out, hidden = jm(mx.nd.array(x), hidden)
            loss = jloss_fn(out, mx.nd.array(y).reshape((-1,)))
        loss.backward()
        norm = jgl.utils.clip_global_norm(
            [p.grad() for p in jm.collect_params().values()],
            CLIP * BATCH)
        jtrainer.step(BATCH)
        want.append((float(loss.mean().asnumpy()), norm))

    tm = word_lm.RNNModel(V, E, HID, NL, dropout=0.0, device="cpu")
    trainer = gluon.Trainer(tm.collect_params(), "sgd",
                            {"learning_rate": 1.0})
    load_mxnet_tpu_params(tm, params)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    hidden = tm.begin_state(batch_size=BATCH, device="cpu")
    for (x, y), (wloss, wnorm) in zip(batches, want):
        hidden = word_lm.detach(hidden)
        with autograd.record():
            out, hidden = tm(torch.from_numpy(x.copy()), hidden)
            loss = loss_fn(out, torch.from_numpy(y.copy()).reshape(-1))
        autograd.backward(loss)
        norm = gluon.utils.clip_global_norm(
            [p.grad for p in tm.collect_params().values()],
            CLIP * BATCH)
        trainer.step(BATCH)
        assert norm > CLIP * BATCH  # the clip rescales every step
        np.testing.assert_allclose(float(loss.detach().mean()), wloss,
                                   rtol=1e-4)
        np.testing.assert_allclose(norm, wnorm, rtol=1e-4)
    final = {k: p.data().asnumpy()
             for k, p in jm._collect_params_with_prefix().items()}
    for name, p in tm.collect_params().items():
        np.testing.assert_allclose(p.detach().numpy(), final[name],
                                   rtol=0, atol=1e-4, err_msg=name)
