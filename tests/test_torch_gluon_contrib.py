"""``gluon.contrib`` of the PyTorch port against the JAX package's.

Every class of ``contrib.nn`` (Concurrent, HybridConcurrent, Identity,
SyncBatchNorm, PixelShuffle1D/2D/3D), ``contrib.rnn`` (LSTMPCell,
VariationalDropoutCell, the nine convolutional cells) and
``contrib.data.IntervalSampler``, built in both packages with the same
prefixes and weights (the JAX package's Xavier draws copied by name):
names and parameter keys equal, outputs and states of a step (or a
recorded forward) within 1e-5 of the largest magnitude, parameter
gradients of the cells within 1e-5 of theirs; the graph of a step on
Symbols equal to the JAX package's JSON inside both packages'
``NameManager`` scopes.  Inputs are seeded numpy arrays.
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

TOL = 1e-5


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _copy(tblock, jblock):
    tparams = tblock.collect_params()
    assert list(tparams) == list(jblock.collect_params())
    for name, p in jblock.collect_params().items():
        tparams[name].set_data(p.data().asnumpy())


CELLS = {
    "Conv1DRNNCell": (dict(input_shape=(3, 9), hidden_channels=4,
                           i2h_kernel=3, h2h_kernel=3, i2h_pad=1), (2, 3, 9)),
    "Conv2DRNNCell": (dict(input_shape=(3, 6, 6), hidden_channels=4,
                           i2h_kernel=3, h2h_kernel=3, activation="relu"),
                      (2, 3, 6, 6)),
    "Conv3DRNNCell": (dict(input_shape=(2, 4, 5, 5), hidden_channels=3,
                           i2h_kernel=(1, 3, 3), h2h_kernel=3,
                           i2h_pad=(0, 1, 1)), (2, 2, 4, 5, 5)),
    "Conv1DLSTMCell": (dict(input_shape=(3, 9), hidden_channels=4,
                            i2h_kernel=5, h2h_kernel=3, i2h_dilate=2),
                       (2, 3, 9)),
    "Conv2DLSTMCell": (dict(input_shape=(3, 8, 8), hidden_channels=4,
                            i2h_kernel=3, h2h_kernel=3, i2h_pad=1),
                       (2, 3, 8, 8)),
    "Conv3DLSTMCell": (dict(input_shape=(2, 3, 4, 4), hidden_channels=2,
                            i2h_kernel=1, h2h_kernel=3), (2, 2, 3, 4, 4)),
    "Conv1DGRUCell": (dict(input_shape=(3, 9), hidden_channels=4,
                           i2h_kernel=3, h2h_kernel=5, h2h_dilate=2),
                      (2, 3, 9)),
    "Conv2DGRUCell": (dict(input_shape=(3, 7, 7), hidden_channels=4,
                           i2h_kernel=3, h2h_kernel=3, i2h_pad=1),
                      (2, 3, 7, 7)),
    "Conv3DGRUCell": (dict(input_shape=(2, 3, 4, 4), hidden_channels=2,
                           i2h_kernel=3, h2h_kernel=1, i2h_pad=1),
                      (2, 2, 3, 4, 4)),
    "LSTMPCell": (dict(hidden_size=6, projection_size=3, input_size=4),
                  (2, 4)),
}


def _cell(pkg, name, prefix="cell_"):
    return getattr(pkg.gluon.contrib.rnn, name)(prefix=prefix,
                                                **CELLS[name][0])


def _step(cell, x, states, nd):
    """One recorded step, the sum of the output and states as the loss;
    (outputs, gradients by name)."""
    with nd.autograd.record():
        out, new = cell(x, states)
        loss = out.sum()
        for s in new:
            loss = loss + s.sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in cell.collect_params().items()}
    return [o.asnumpy() for o in [out] + list(new)], grads


@pytest.mark.parametrize("name", sorted(CELLS))
def test_contrib_cell_step_matches_jax(name):
    rng = np.random.RandomState(0)
    jcell = _cell(jmx, name)
    jmx.random.seed(2)
    jcell.initialize(jmx.init.Xavier())
    with tmx.cpu():
        tcell = _cell(tmx, name)
        tcell.initialize()
    assert tcell.prefix == jcell.prefix
    _copy(tcell, jcell)
    x = rng.randn(*CELLS[name][1]).astype(np.float32)
    states = [rng.randn(*info["shape"]).astype(np.float32)
              for info in jcell.state_info(x.shape[0])]
    assert [i["shape"] for i in tcell.state_info(2)] == \
        [i["shape"] for i in jcell.state_info(2)]
    want, wgrads = _step(jcell, jmx.nd.array(x),
                         [jmx.nd.array(s) for s in states], jmx)
    with tmx.cpu():
        got, ggrads = _step(tcell, tmx.nd.array(x),
                            [tmx.nd.array(s) for s in states], tmx)
    for g, w in zip(got, want):
        _close(g, w)
    for k, w in wgrads.items():
        _close(ggrads[k], w, k)
    # the same step on Symbols: the JAX package's graph
    n = len(states)
    with tmx.cpu(), NameManager():
        out, new = _cell(tmx, name)(tmx.sym.var("x"), [
            tmx.sym.var("s%d" % i) for i in range(n)])
        tjson = tmx.sym.Group([out] + list(new)).tojson()
    with JaxNameManager():
        out, new = _cell(jmx, name)(jmx.sym.var("x"), [
            jmx.sym.var("s%d" % i) for i in range(n)])
        jjson = jmx.sym.Group([out] + list(new)).tojson()
    assert json.loads(tjson) == json.loads(jjson)


def test_variational_dropout_cell_matches_jax_in_predict_mode():
    """Predict mode: the masks are ones, so the wrapped LSTMCell's step
    twice over (masks kept across the steps) equals the JAX package's;
    in train mode one mask a sequence, drawn at the first step, kept
    until reset()."""
    def make(pkg):
        base = pkg.gluon.rnn.LSTMCell(5, input_size=4, prefix="base_")
        return pkg.gluon.contrib.rnn.VariationalDropoutCell(
            base, drop_inputs=0.5, drop_states=0.5, drop_outputs=0.5)

    rng = np.random.RandomState(1)
    jcell = make(jmx)
    jcell.initialize(jmx.init.Xavier())
    with tmx.cpu():
        tcell = make(tmx)
        tcell.initialize()
    assert tcell.prefix == jcell.prefix == "base__modifier_"
    _copy(tcell, jcell)
    xs = [rng.randn(3, 4).astype(np.float32) for _ in range(2)]
    jst = [jmx.nd.zeros((3, 5)), jmx.nd.zeros((3, 5))]
    with tmx.cpu():
        tst = [tmx.nd.zeros((3, 5)), tmx.nd.zeros((3, 5))]
        for x in xs:
            jout, jst = jcell(jmx.nd.array(x), jst)
            tout, tst = tcell(tmx.nd.array(x), tst)
            _close(tout.asnumpy(), jout.asnumpy())
    # train mode: the masks of the first step are kept
    tcell.reset()
    with tmx.cpu(), tmx.autograd.record():
        tst = [tmx.nd.ones((3, 5)), tmx.nd.ones((3, 5))]
        tcell(tmx.nd.array(np.ones((3, 4), np.float32)), tst)
        masks = [tcell.drop_inputs_mask, tcell.drop_states_mask,
                 tcell.drop_outputs_mask]
        tcell(tmx.nd.array(np.ones((3, 4), np.float32)), tst)
    assert [m is k for m, k in zip(masks, [
        tcell.drop_inputs_mask, tcell.drop_states_mask,
        tcell.drop_outputs_mask])] == [True] * 3
    vals = np.unique(masks[0].numpy())
    assert set(vals.tolist()) <= {0.0, 2.0}
    tcell.reset()
    assert tcell.drop_inputs_mask is None


def _concurrent(pkg, hybrid):
    cls = pkg.gluon.contrib.nn.HybridConcurrent if hybrid \
        else pkg.gluon.contrib.nn.Concurrent
    net = cls(axis=1, prefix="cc_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(3, in_units=5, activation="tanh"),
                pkg.gluon.contrib.nn.Identity(),
                pkg.gluon.nn.Dense(2, in_units=5))
    return net


@pytest.mark.parametrize("hybrid", [False, True],
                         ids=["Concurrent", "HybridConcurrent"])
def test_concurrent_and_identity_match_jax(hybrid):
    x = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    jnet = _concurrent(jmx, hybrid)
    jnet.initialize(jmx.init.Xavier())
    with tmx.cpu():
        tnet = _concurrent(tmx, hybrid)
        tnet.initialize()
    _copy(tnet, jnet)
    want = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        _close(tnet(tmx.nd.array(x)).asnumpy(), want)
    _close(tnet(torch.from_numpy(x)).numpy(), want)
    if hybrid:
        tnet.hybridize()
        _close(tnet(torch.from_numpy(x)).numpy(), want)
        with NameManager(), tmx.cpu():
            tjson = _concurrent(tmx, True)(tmx.sym.var("data")).tojson()
        with JaxNameManager():
            jjson = _concurrent(jmx, True)(jmx.sym.var("data")).tojson()
        assert json.loads(tjson) == json.loads(jjson)
    else:
        with pytest.raises(MXNetError, match="none either"):
            tnet(tmx.sym.var("data"))


def test_sync_batch_norm_matches_jax():
    """Train-mode output, running statistics and gradients, then a
    predict-mode output; on a Symbol a BatchNorm node over axis 1."""
    x = np.random.RandomState(3).randn(4, 3, 5, 5).astype(np.float32)
    jbn = jmx.gluon.contrib.nn.SyncBatchNorm(in_channels=3, num_devices=8,
                                             prefix="sbn_")
    jbn.initialize()
    with tmx.cpu():
        tbn = tmx.gluon.contrib.nn.SyncBatchNorm(in_channels=3,
                                                 num_devices=8,
                                                 prefix="sbn_")
        tbn.initialize()
    assert list(tbn.collect_params()) == list(jbn.collect_params())
    jx = jmx.nd.array(x)
    jx.attach_grad()
    with jmx.autograd.record():
        jy = jbn(jx)
        (jy * jy).sum().backward()
    with tmx.cpu():
        tx = tmx.nd.array(x)
        tx.attach_grad()
        with tmx.autograd.record():
            ty = tbn(tx)
            (ty * ty).sum().backward()
    _close(ty.asnumpy(), jy.asnumpy())
    _close(tx.grad.asnumpy(), jx.grad.asnumpy())
    for name in ("running_mean", "running_var", "gamma"):
        jp = getattr(jbn, name)
        tp = getattr(tbn, name)
        _close(tp.data().asnumpy(), jp.data().asnumpy(), name)
        if name == "gamma":
            _close(tp.grad().asnumpy(), jp.grad().asnumpy(), name)
    with tmx.cpu():
        _close(tbn(tmx.nd.array(x)).asnumpy(), jbn(jmx.nd.array(x))
               .asnumpy())
    with tmx.cpu():
        sym = tbn(tmx.sym.var("data"))
    node = json.loads(sym.tojson())["nodes"][-1]
    assert node["op"] == "BatchNorm" and node["attrs"]["axis"] == "1"


@pytest.mark.parametrize("name,factor,shape", [
    ("PixelShuffle1D", 4, (2, 8, 5)),
    ("PixelShuffle2D", 2, (2, 8, 3, 4)),
    ("PixelShuffle2D", (1, 4), (2, 8, 3, 4)),
    ("PixelShuffle3D", (2, 1, 2), (2, 8, 2, 3, 3)),
])
def test_pixel_shuffle_matches_jax(name, factor, shape):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = getattr(jmx.gluon.contrib.nn, name)(factor)(
        jmx.nd.array(x)).asnumpy()
    block = getattr(tmx.gluon.contrib.nn, name)(factor)
    got = block(torch.from_numpy(x))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    with tmx.cpu():
        assert np.array_equal(block(tmx.nd.array(x)).asnumpy(), want)
    assert repr(block) == repr(getattr(jmx.gluon.contrib.nn, name)(factor))


@pytest.mark.parametrize("length,interval,rollover", [
    (10, 3, True), (10, 3, False), (7, 7, True), (12, 4, True)])
def test_interval_sampler_matches_jax(length, interval, rollover):
    t = tmx.gluon.contrib.data.IntervalSampler(length, interval, rollover)
    j = jmx.gluon.contrib.data.IntervalSampler(length, interval, rollover)
    assert list(t) == list(j) and len(t) == len(j)


def test_interval_sampler_batches_a_dataloader():
    data = tmx.gluon.data.ArrayDataset(np.arange(10, dtype=np.float32))
    sampler = tmx.gluon.contrib.data.IntervalSampler(10, 5)
    with tmx.cpu():
        batches = [b.asnumpy().tolist() for b in tmx.gluon.data.DataLoader(
            data, batch_size=4, sampler=sampler)]
    assert batches == [[0, 5, 1, 6], [2, 7, 3, 8], [4, 9]]
    with pytest.raises(ValueError):
        tmx.gluon.contrib.data.IntervalSampler(3, 4)
