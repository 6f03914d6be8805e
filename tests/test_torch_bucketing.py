"""The port's bucketed recurrent training path against the JAX package's
on the CPU: ``encode_sentences``, ``BucketSentenceIter``'s batches and
their order under one seed, ``BucketingModule.fit`` of
example/rnn/bucketing/lstm_bucketing.py's model at small widths over
three buckets (every parameter within 1e-4 of the JAX Module's largest
magnitude after the trajectory), the shared parameter storage and
optimizer states across buckets (no host copy at a switch),
``state_names`` with ``get_states``/``set_states``, and the recurrent
checkpoints crossing both ways.

The JAX Module is given an SGD whose ``set_wd_mult({})`` was called:
MXNet's optimizer applies the no-decay rule in its constructor, which
the port does and the JAX package's optimizer does not."""

import logging
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.module import executor_group
from mxnet_tpu_torch.name import NameManager as TNameManager

CPU = tmx.cpu()
VOCAB, EMBED, HIDDEN, LAYERS = 20, 8, 12, 2
BATCH, BUCKETS = 4, [4, 6, 8]
TOL = 1e-4
PKGS = {"jax": (jmx, JNameManager), "port": (tmx, TNameManager)}


def corpus(n=60, seed=7):
    """lstm_bucketing.py's noisy ring walks, 2 to 8 tokens long."""
    rs = np.random.RandomState(seed)
    sentences = []
    for _ in range(n):
        tok = int(rs.randint(1, VOCAB))
        sent = [tok]
        for _ in range(int(rs.randint(2, 9)) - 1):
            tok = (tok + 1) % VOCAB if rs.rand() < 0.85 \
                else int(rs.randint(1, VOCAB))
            sent.append(tok or 1)
        sentences.append(sent)
    return sentences


def sym_gen_of(mx, fused=False):
    """lstm_bucketing.py's build_sym_gen (the FusedRNNCell form is
    upstream's cudnn_rnn_bucketing.py)."""
    if fused:
        stack = mx.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS, mode="lstm",
                                    prefix="lstm_")
    else:
        stack = mx.rnn.SequentialRNNCell()
        for i in range(LAYERS):
            stack.add(mx.rnn.LSTMCell(HIDDEN, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=VOCAB,
                                 output_dim=EMBED, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=VOCAB,
                                     name="pred")
        flat_label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=flat_label,
                                    name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen, stack


def _iters(mx, sentences, seed=0):
    random.seed(seed)
    np.random.seed(seed)
    split = len(sentences) * 3 // 4
    return (mx.rnn.BucketSentenceIter(sentences[:split], BATCH,
                                      buckets=BUCKETS, invalid_label=0),
            mx.rnn.BucketSentenceIter(sentences[split:], BATCH,
                                      buckets=BUCKETS, invalid_label=0))


def _batches(it):
    return [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
             [tuple(d.shape) for d in b.provide_data],
             [tuple(d.shape) for d in b.provide_label]) for b in it]


def test_encode_sentences_equals_jax():
    words = [["the", "cat", "sat"], ["a", "cat"], ["the", "dog", "ran"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 0},
               {"invalid_label": 2, "start_label": 1}):
        assert tmx.rnn.encode_sentences(words, **kw) == \
            jmx.rnn.encode_sentences(words, **kw)
    _, vocab = tmx.rnn.encode_sentences(words)
    frozen = {**vocab, "<unk>": 99}
    got = tmx.rnn.encode_sentences([["the", "emu"]], vocab=dict(frozen),
                                   unknown_token="<unk>")
    assert got == jmx.rnn.encode_sentences([["the", "emu"]],
                                           vocab=dict(frozen),
                                           unknown_token="<unk>")
    assert got[0] == [[vocab["the"], 99]]
    with pytest.raises(ValueError):
        tmx.rnn.encode_sentences([["emu"]], vocab=dict(vocab))


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_batches_and_order_equal_jax(layout):
    """The same batches, keys and shapes in the same order, under one
    seed of ``random`` and numpy, over two passes (a reset between)."""
    sentences = corpus() + [[1] * 12]  # one longer than every bucket
    runs = {}
    for pkg, mx in (("jax", jmx), ("port", tmx)):
        random.seed(3)
        np.random.seed(3)
        it = mx.rnn.BucketSentenceIter(sentences, BATCH, buckets=BUCKETS,
                                       invalid_label=0, layout=layout)
        first = _batches(it)
        it.reset()
        runs[pkg] = (first + _batches(it), it.default_bucket_key,
                     it.buckets, [tuple(d.shape) for d in it.provide_data])
    assert runs["port"][1:] == runs["jax"][1:]
    got, want = runs["port"][0], runs["jax"][0]
    assert len(got) == len(want) > 2 * len(BUCKETS)
    assert {b[0] for b in got} == set(BUCKETS)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3:] == w[3:]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    # the label is the data shifted by one token, padded with 0
    key, data, label = got[0][:3]
    if layout == "TN":
        data, label = data.T, label.T
    np.testing.assert_array_equal(label[:, :-1], data[:, 1:])
    assert (label[:, -1] == 0).all() and data.shape == (BATCH, key)


def test_default_buckets_and_host_batches():
    sentences = [[1, 2]] * 5 + [[1, 2, 3]] * 2 + [[4] * 5] * 4
    it = tmx.rnn.BucketSentenceIter(sentences, 4)
    jit = jmx.rnn.BucketSentenceIter(sentences, 4)
    assert it.buckets == jit.buckets == [2, 5]
    batch = next(iter(it))
    assert batch.data[0].context == CPU  # the executor copies it
    with pytest.raises(ValueError):
        tmx.rnn.BucketSentenceIter([[1] * 5], 4, buckets=[3])


def _jax_sgd(sym, mod, **kw):
    sgd = jmx.optimizer.create(
        "sgd", sym=sym, rescale_grad=1.0 / BATCH,
        param_idx2name=dict(enumerate(mod._curr_module._param_names)), **kw)
    sgd.set_wd_mult({})
    return sgd


SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}


def _bind_every_bucket(jmod, it, keys=BUCKETS):
    """Bind the JAX Module's every bucket before training: there a bucket
    bound after an update of another bucket takes the default bucket's
    stale host copies (``Module.bind(shared_module=...)`` calls
    ``set_params(*shared_module.get_params())``, and the default Module
    is not dirty), which undoes that update in the shared storage
    (:func:`test_a_new_bucket_keeps_the_last_update`)."""
    for key in keys:
        shape = (BATCH, key) if it.major_axis == 0 else (key, BATCH)
        jmod.switch_bucket(key, [("data", shape)],
                           [("softmax_label", shape)])
    jmod.switch_bucket(it.default_bucket_key, it.provide_data,
                       it.provide_label)


@pytest.mark.parametrize("fused", [False, True], ids=["cells", "fused"])
def test_fit_trajectory_equals_jax(fused):
    """Two epochs of BucketingModule.fit over three buckets with a
    validation iterator, from the JAX Module's initial parameters: every
    parameter within 1e-4 of the JAX Module's largest magnitude, the
    training and validation perplexities within 1e-4.  The port's
    FusedRNNCell form (upstream's cudnn_rnn_bucketing.py) is held to the
    JAX package's LSTMCell stack, its weights carried through
    ``unpack_weights``/``pack_weights``: the JAX package cannot bind the
    fused form (:func:`test_jax_cannot_infer_the_fused_form`); there the
    weight decay is 0, as MXNet's no-decay rule exempts the packed
    ``lstm_parameters`` (no ``_weight`` suffix) from it."""
    sgd = dict(SGD, wd=0.0) if fused else SGD
    sentences = corpus()
    with JNameManager():
        jgen, jstack = sym_gen_of(jmx)
    jtrain, jval = _iters(jmx, sentences)
    jmod = jmx.mod.BucketingModule(jgen, jtrain.default_bucket_key,
                                   context=jmx.cpu())
    jmod.bind(jtrain.provide_data, jtrain.provide_label)
    jmx.random.seed(1)
    jmod.init_params(jmx.init.Xavier(factor_type="in", magnitude=2.34))
    init = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    _bind_every_bucket(jmod, jtrain)
    jmetric, jval_metric = jmx.metric.Perplexity(0), \
        jmx.metric.Perplexity(0)
    random.seed(5)
    np.random.seed(5)
    jmod.fit(jtrain, eval_data=jval, eval_metric=jmetric,
             validation_metric=jval_metric, num_epoch=2,
             optimizer=_jax_sgd(jmod.symbol, jmod, **sgd))

    with TNameManager():
        tgen, tstack = sym_gen_of(tmx, fused)
    start = {k: tmx.nd.array(v, ctx=CPU) for k, v in init.items()}
    if fused:
        start = tstack.pack_weights(tstack.unfuse().unpack_weights(start))
    ttrain, tval = _iters(tmx, sentences)
    tmod = tmx.mod.BucketingModule(tgen, ttrain.default_bucket_key,
                                   context=CPU)
    tmetric, tval_metric = tmx.metric.Perplexity(0), \
        tmx.metric.Perplexity(0)
    random.seed(5)
    np.random.seed(5)
    seen = []
    tmod.fit(ttrain, eval_data=tval, eval_metric=tmetric,
             validation_metric=tval_metric, num_epoch=2, optimizer="sgd",
             optimizer_params=sgd, arg_params=start,
             batch_end_callback=lambda p: seen.append(
                 tmod._curr_bucket_key))
    assert set(seen) == set(BUCKETS) and sorted(tmod._buckets) == BUCKETS
    jargs, targs = jmod.get_params()[0], tmod.get_params()[0]
    if fused:
        targs = tstack.unfuse().pack_weights(tstack.unpack_weights(targs))
    assert sorted(jargs) == sorted(targs)
    for k in jargs:
        w = jargs[k].asnumpy()
        assert np.abs(w - init[k]).max() > 1e-3, k  # it moved
        np.testing.assert_allclose(targs[k].asnumpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max())
    for got, want in ((tmetric, jmetric), (tval_metric, jval_metric)):
        np.testing.assert_allclose(got.get()[1], want.get()[1], rtol=TOL)
    scores = []
    for mod, it, mx in ((tmod, tval, tmx), (jmod, jval, jmx)):
        random.seed(9)  # the reset's shuffles
        np.random.seed(9)
        scores.append(mod.score(it, mx.metric.Perplexity(0))[0][1])
    np.testing.assert_allclose(scores[0], scores[1], rtol=TOL)


def test_jax_cannot_infer_the_fused_form():
    """A fault of the reference, kept there: after a FusedRNNCell unroll
    over an Embedding, the JAX package's shape inference leaves the
    FullyConnected's parameters unsolved, so its BucketingModule cannot
    bind cudnn_rnn_bucketing.py's model; the port's solves them."""
    shapes = {"data": (BATCH, 8), "softmax_label": (BATCH, 8)}
    got = {}
    for pkg, (mx, nm) in PKGS.items():
        with nm():
            sym = sym_gen_of(mx, fused=True)[0](8)[0]
        got[pkg] = sym.infer_shape_partial(**shapes)
    assert got["jax"][1] is None
    assert got["port"][1] == [(BATCH * 8, VOCAB)]
    assert dict(zip(sym.list_arguments(), got["port"][0]))[
        "pred_weight"] == (VOCAB, HIDDEN)


def _steps(mod, it, keys, sync):
    """One forward_backward + update a key; with ``sync``, the host copies
    read back after each update.  Returns the parameters after it all."""
    for key in keys:
        mod.forward_backward(_batch_of(it, key))
        mod.update()
        if sync:
            mod.get_params()
    return {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}


def test_a_new_bucket_keeps_the_last_update():
    """A bucket bound after another bucket's update starts from the
    current parameters: the port's steps give the same parameters whether
    or not the host copies were read back between them, and whether or
    not every bucket was bound first; the JAX package's lose the update
    before each new bucket's bind (a fault of the reference, kept there:
    its default Module's host copies are stale but not dirty)."""
    keys = (8, 4, 6, 4, 8)
    got, init = {}, None
    for pkg in PKGS:
        mx, nm = PKGS[pkg]
        with nm():
            gen, _ = sym_gen_of(mx)
        for sync, prebind in ((False, False), (True, False), (False, True)):
            it, _ = _iters(mx, corpus())
            mod = mx.mod.BucketingModule(gen, 8, context=mx.cpu())
            mod.bind(it.provide_data, it.provide_label)
            if init is None:
                mod.init_params(mx.init.Xavier())
                init = {k: v.asnumpy() for k, v in
                        mod.get_params()[0].items()}
            else:
                mod.init_params(arg_params={
                    k: mx.nd.array(v, ctx=mx.cpu())
                    for k, v in init.items()})
            if prebind:
                _bind_every_bucket(mod, it)
            if pkg == "jax":
                mod.init_optimizer(optimizer=_jax_sgd(mod.symbol, mod,
                                                      **SGD))
            else:
                mod.init_optimizer(optimizer_params=SGD)
            got[pkg, sync, prebind] = _steps(mod, it, keys, sync)
    want = got["jax", False, True]
    for run in ((False, False), (True, False), (False, True)):
        for k, w in want.items():
            np.testing.assert_allclose(got[("port",) + run][k], w, rtol=0,
                                       atol=TOL * np.abs(w).max())
    lost = got["jax", False, False]
    assert max(np.abs(lost[k] - want[k]).max() for k in want) > 1e-2


def _bound(sym_gen=None, momentum=0.9):
    sym_gen = sym_gen or sym_gen_of(tmx)[0]
    train, _ = _iters(tmx, corpus())
    mod = tmx.mod.BucketingModule(sym_gen, train.default_bucket_key,
                                  context=CPU)
    mod.bind(train.provide_data, train.provide_label)
    tmx.random.seed(0)
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": momentum})
    return mod, train


def _batch_of(it, key):
    """The first batch of bucket ``key`` after a reset under a fixed
    seed."""
    random.seed(key)
    np.random.seed(key)
    it.reset()
    return next(b for b in it if b.bucket_key == key)


def test_switch_shares_storage_and_moves_nothing_through_the_host(
        monkeypatch):
    """After an update through one bucket, every other bucket's executor
    holds the same tensors (one storage, the same values); switching
    copies no parameter (no device-to-host read of a parameter), and
    every bucket updates through one momentum a parameter."""
    mod, it = _bound()
    reads = []
    monkeypatch.setattr(executor_group.DataParallelExecutorGroup,
                        "get_params",
                        lambda self, *a: reads.append(1))
    for key in (8, 4, 6, 4, 8):
        mod.forward_backward(_batch_of(it, key))
        mod.update()
    assert reads == []  # no parameter went through the host
    monkeypatch.undo()
    execs = {k: m._exec_group.execs[0] for k, m in mod._buckets.items()}
    default = execs[8]
    for key, ex in execs.items():
        for name in mod._buckets[8]._param_names:
            a, b = ex.arg_dict[name], default.arg_dict[name]
            assert a is b
            assert a.data_torch.data_ptr() == b.data_torch.data_ptr()
        # the gradients are each bucket's own
        assert ex.grad_dict["pred_weight"] is not \
            default.grad_dict["pred_weight"] or key == 8
    updater = mod._buckets[8]._updater
    assert all(m._updater is updater for m in mod._buckets.values())
    n = len(mod._buckets[8]._param_names)
    assert sorted(updater.states) == list(range(n))
    assert updater.optimizer.num_update == 5
    # the host copies are one dict, read back once, equal to the device
    args = mod.get_params()[0]
    assert all(m._arg_params is args for m in mod._buckets.values())
    for name, v in args.items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      default.arg_dict[name].asnumpy())


def _two_orders(key):
    """Two products whose arguments list in another order in the default
    bucket (8) than in the others."""
    mx = tmx
    data = mx.sym.Variable("data")
    first, second = ("a", "b") if key == 8 else ("b", "a")
    x = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                         name="embed")
    x = mx.sym.Reshape(x, shape=(-1, EMBED))
    out = {}
    for name in (first, second):
        out[name] = mx.sym.FullyConnected(x, num_hidden=VOCAB, name=name)
    pred = mx.sym.SoftmaxOutput(out[first] + out[second],
                                mx.sym.Reshape(mx.sym.Variable(
                                    "softmax_label"), shape=(-1,)),
                                name="softmax")
    return pred, ("data",), ("softmax_label",)


def test_optimizer_state_is_keyed_by_name_across_buckets():
    """Buckets whose symbols list the parameters in another order update
    each parameter through the default bucket's index for it (one
    momentum a parameter)."""
    mod, it = _bound(_two_orders)
    for key in (8, 4, 6):
        mod.forward_backward(_batch_of(it, key))
        mod.update()
    default, even = mod._buckets[8], mod._buckets[4]
    assert default._param_names != even._param_names == \
        mod._buckets[6]._param_names
    index = {n: i for i, n in enumerate(default._param_names)}
    for m in mod._buckets.values():
        keys = m._update_keys or range(len(m._param_names))
        assert dict(zip(m._param_names, keys)) == index
    assert sorted(default._updater.states) == sorted(index.values())


def test_bucket_with_a_parameter_the_default_lacks_raises():
    def gen(key):
        sym, names, labels = sym_gen_of(tmx)[0](key)
        if key == 4:
            sym = tmx.sym.FullyConnected(sym, num_hidden=3, name="extra")
        return sym, names, labels

    mod, it = _bound(gen)
    mon = tmx.mon.Monitor(1)
    mod.install_monitor(mon)
    with pytest.raises(MXNetError):
        mod.forward(_batch_of(it, 4))
    # the bucket that failed its bind left no executor to watch
    assert len(mon.exes) == 1
    with pytest.raises(MXNetError):
        tmx.mod.BucketingModule(gen)


def _state_sym(mx, seq_len=4):
    cell = mx.rnn.LSTMCell(HIDDEN, prefix="s_")
    embed = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=VOCAB,
                             output_dim=EMBED, name="embed")
    outs, states = cell.unroll(seq_len, inputs=embed,
                               begin_state=cell.begin_state(
                                   func=mx.sym.Variable),
                               merge_outputs=True)
    return mx.sym.Group([mx.sym.Reshape(outs, shape=(-1, HIDDEN))]
                        + states)


def _state_module(pkg, params):
    mx, nm = PKGS[pkg]
    with nm():
        sym = _state_sym(mx)
    mod = mx.mod.Module(sym, data_names=["data"], label_names=None,
                        state_names=["s_begin_state_0", "s_begin_state_1"],
                        context=mx.cpu())
    mod.bind([("data", (BATCH, 4))], for_training=False)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in params.items()})
    return mod


def test_state_names_get_and_set_states_equal_jax():
    """A cell's Variable begin states as Module state inputs: bound at the
    batch, set to a value or to arrays (the last states fed back), the
    outputs equal to the JAX Module's."""
    rng = np.random.RandomState(2)
    with TNameManager():
        sym = _state_sym(tmx)
    shapes = dict(zip(sym.list_arguments(), sym.infer_shape(
        data=(BATCH, 4), s_begin_state_0=(BATCH, HIDDEN),
        s_begin_state_1=(BATCH, HIDDEN))[0]))
    params = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for k, s in shapes.items() if not k.startswith(("data", "s_b"))}
    mods = {pkg: _state_module(pkg, params) for pkg in PKGS}
    assert [tuple(s.shape) for s in mods["port"].get_states()] == \
        [(BATCH, HIDDEN)] * 2
    data = rng.randint(0, VOCAB, (BATCH, 4)).astype(np.float32)
    outs = {}
    for pkg, mod in mods.items():
        mx = PKGS[pkg][0]
        batch = mx.io.DataBatch([mx.nd.array(data, ctx=mx.cpu())])
        mod.set_states(value=0.25)
        mod.forward(batch, is_train=False)
        first = [o.asnumpy() for o in mod.get_outputs()]
        mod.set_states(states=mod.get_outputs()[1:])
        np.testing.assert_array_equal(mod.get_states()[1].asnumpy(),
                                      first[2])
        mod.forward(batch, is_train=False)
        outs[pkg] = first + [o.asnumpy() for o in mod.get_outputs()]
        with pytest.raises((ValueError, AssertionError)):
            mod.set_states()
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not np.allclose(outs["port"][0], outs["port"][3])


def test_bucketing_module_state_names():
    def gen(key):
        with TNameManager():
            return _state_sym(tmx, key), ("data",), None

    mod = tmx.mod.BucketingModule(gen, 8, context=CPU,
                                  state_names=["s_begin_state_0",
                                               "s_begin_state_1"])
    mod.bind([("data", (BATCH, 8))], for_training=False)
    mod.init_params(tmx.init.Xavier())
    for key in (8, 4):
        batch = tmx.io.DataBatch(
            [tmx.nd.ones((BATCH, key), ctx=CPU)], bucket_key=key,
            provide_data=[("data", (BATCH, key))])
        mod.forward(batch, is_train=False)  # switches to the bucket
        mod.set_states(value=1.0)
        assert (mod.get_states()[0].asnumpy() == 1.0).all()
        mod.forward(batch, is_train=False)
        assert mod.get_outputs()[0].shape == (BATCH * key, HIDDEN)
    assert mod._buckets[4].get_states()[0] is not \
        mod._buckets[8].get_states()[0]


def test_rnn_checkpoints_cross_both_ways(tmp_path):
    """save_rnn_checkpoint writes every cell's weights unpacked; a fused
    cell's checkpoint of either package loads, packed, into the other's
    fused cell and unpacked into its unfused stack."""
    size = tmx.ops.rnn.rnn_param_size(LAYERS, EMBED, HIDDEN, False, "lstm")
    vec = np.random.RandomState(4).randn(size).astype(np.float32)
    extra = np.arange(3, dtype=np.float32)
    for src, dst in (("port", "jax"), ("jax", "port")):
        smx, dmx = PKGS[src][0], PKGS[dst][0]
        cell = smx.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS,
                                    prefix="lstm_")
        sym, _ = cell.unroll(3, inputs=smx.sym.Variable("data"),
                             merge_outputs=True)
        prefix = str(tmp_path / src)
        args = {"lstm_parameters": smx.nd.array(vec, ctx=smx.cpu()),
                "other_weight": smx.nd.array(extra, ctx=smx.cpu())}
        smx.rnn.do_rnn_checkpoint(cell, prefix, period=2)(
            1, sym, args, {})
        dcell = dmx.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS,
                                     prefix="lstm_")
        load = dmx.rnn.load_rnn_checkpoint
        kw = {"ctx": CPU} if dst == "port" else {}
        _, arg, _ = load(dcell, prefix, 2, **kw)
        np.testing.assert_array_equal(arg["lstm_parameters"].asnumpy(), vec)
        np.testing.assert_array_equal(arg["other_weight"].asnumpy(), extra)
        _, unfused, _ = load(dcell.unfuse(), prefix, 2, **kw)
        assert "lstm_l1_h2h_weight" in unfused and \
            unfused["lstm_l1_h2h_weight"].shape == (4 * HIDDEN, HIDDEN)
        saved = jmx.nd.load("%s-0002.params" % prefix)
        assert "arg:lstm_l0_i2h_f_weight" in saved
    with pytest.warns(UserWarning):
        tmx.rnn.rnn_unroll(tmx.rnn.LSTMCell(HIDDEN), 2,
                           inputs=tmx.sym.Variable("data"))
