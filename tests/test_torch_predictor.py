"""The port's Predictor (mxnet_tpu_torch/predictor.py) on the CPU,
against the JAX package's on the same exported files: a HybridSequential
(Dense 7, Dense 3) exported by the JAX package with ``block.export``.
Outputs within 1e-5 (two packages' float32 products; the port on the
CPU runs the same ops in another order); the weights shared by
``reshape`` and ``_reshape_clone``; the port's server over the Predictor
against the JAX server over the JAX Predictor (1e-5, equal
``bucket_compiles``); the predict forward captured once a bound executor
(its caching on the CPU through an eager stand-in for the capture)."""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import histogram as jhistogram
from mxnet_tpu import ndarray as jnd
from mxnet_tpu import runtime_stats as jrts
from mxnet_tpu import serving as jserving
from mxnet_tpu.predictor import Predictor as JaxPredictor
from mxnet_tpu.predictor import load_ndarray_file as jax_load_ndarray_file

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, _capture
from mxnet_tpu_torch import histogram, runtime_stats, serving
from mxnet_tpu_torch.predictor import Predictor, load_ndarray_file
from mxnet_tpu_torch.serving import InferenceServer

TOL = 1e-5
IN = 5


@pytest.fixture(autouse=True)
def _clean_state():
    """Both packages' servers raise their histogram layers; put both
    back as they were."""
    was = (jhistogram.is_enabled(), histogram.is_enabled())
    yield
    for srv in jserving.servers():
        srv.stop(drain=False, timeout=5.0)
    for srv in serving.servers():
        srv.stop(drain=False, timeout=5.0)
    jserving.reset()
    jrts.reset()
    serving.reset()
    runtime_stats.reset()
    if not was[0]:
        jhistogram.disable()
    if not was[1]:
        histogram.disable()


@pytest.fixture()
def exported(tmp_path):
    """``(symbol json, params bytes)`` of the JAX-exported dense stack."""
    jmx.random.seed(3)
    block = jgluon.nn.HybridSequential()
    block.add(jgluon.nn.Dense(7))
    block.add(jgluon.nn.Dense(3))
    block.hybridize()
    block.initialize()
    block(jnd.array(np.random.RandomState(0).uniform(size=(1, IN))))
    path = str(tmp_path / "dense")
    block.export(path)
    with open(path + "-symbol.json") as f:
        sym = f.read()
    with open(path + "-0000.params", "rb") as f:
        params = f.read()
    return sym, params


def _x(n, seed):
    return np.random.RandomState(seed).uniform(size=(n, IN)) \
        .astype(np.float32)


def test_predictor_matches_jax_predictor(exported):
    sym, params = exported
    jp = JaxPredictor(sym, params, {"data": (1, IN)})
    pp = Predictor(sym, params, {"data": (1, IN)}, dev_type="cpu")
    for pred in (jp, pp):
        pred.forward(data=_x(1, 1))
    np.testing.assert_allclose(pp.get_output(0), jp.get_output(0),
                               rtol=TOL, atol=TOL)
    assert pp.num_outputs == jp.num_outputs == 1
    assert pp.get_input_names() == jp.get_input_names() == ["data"]
    assert pp.get_output_shape(0) == jp.get_output_shape(0) == (1, 3)
    for pred in (jp, pp):
        pred.reshape({"data": (3, IN)})
        pred.forward(data=_x(3, 2))
    np.testing.assert_allclose(pp.get_output(0), jp.get_output(0),
                               rtol=TOL, atol=TOL)
    assert pp.get_output_shape(0) == jp.get_output_shape(0) == (3, 3)


@pytest.mark.parametrize("how", ["reshape", "reshape_clone"])
def test_reshape_shares_the_weights(exported, how):
    sym, params = exported
    pred = Predictor(sym, params, {"data": (1, IN)}, dev_type="cpu")
    other = pred.reshape({"data": (4, IN)}) if how == "reshape" \
        else pred._reshape_clone({"data": (4, IN)})
    assert other._exec.arg_dict["data"].shape == (4, IN)
    for name, arr in pred._arg_params.items():
        bound = other._exec.arg_dict[name]
        assert bound.data_torch.data_ptr() == arr.data_torch.data_ptr()
    before = other.forward(data=_x(4, 5)).get_output(0)
    weight = next(n for n in pred._arg_params if n.endswith("weight"))
    pred._arg_params[weight].data_torch.mul_(2.0)
    after = other.forward(data=_x(4, 5)).get_output(0)
    assert not np.allclose(before, after)


def test_shape_mismatch_unknown_input_and_device(exported, monkeypatch):
    sym, params = exported
    pred = Predictor(sym, params, {"data": (1, IN)}, dev_type="cpu")
    with pytest.raises(ValueError, match="bound shape"):
        pred.forward(data=np.zeros((2, IN), np.float32))
    with pytest.raises(ValueError, match="not in symbol arguments"):
        Predictor(sym, params, {"not_an_input": (1, IN)}, dev_type="cpu")
    with pytest.raises(ValueError, match="dev_type"):
        Predictor(sym, params, {"data": (1, IN)}, dev_type="npu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev_type in ({}, {"dev_type": "tpu"}):  # the card by default
        with pytest.raises(MXNetError, match="no CUDA device"):
            Predictor(sym, params, {"data": (1, IN)}, **dev_type)


def test_load_ndarray_file_reads_jax_blobs(tmp_path):
    rng = np.random.RandomState(4)
    data = {"a": rng.rand(7, 3).astype(np.float32),
            "b": rng.rand(7).astype(np.float32)}
    arrays = {k: jnd.array(v) for k, v in data.items()}
    for name, blob in (("dict", arrays),
                       ("list", [arrays["a"], arrays["b"]])):
        fname = str(tmp_path / ("%s.params" % name))
        jnd.save(fname, blob)
        with open(fname, "rb") as f:
            raw = f.read()
        got, want = load_ndarray_file(raw), jax_load_ndarray_file(raw)
        assert type(got) is type(want)
        pairs = zip(got, want) if name == "list" else \
            ((got[k], want[k]) for k in want)
        for g, w in pairs:
            np.testing.assert_array_equal(g, w)


def test_server_over_predictor_matches_jax_server(exported):
    sym, params = exported
    jp = JaxPredictor(sym, params, {"data": (1, IN)})
    pp = Predictor(sym, params, {"data": (1, IN)}, dev_type="cpu")
    xs = [_x(n, 10 + n) for n in (1, 3, 2, 4)]
    with jserving.InferenceServer(jp, buckets=(1, 2, 4)) as jsrv:
        jsrv.warmup()
        want = [jsrv.infer(x, timeout=60)[0] for x in xs]
    with InferenceServer(pp, buckets=(1, 2, 4)) as srv:
        assert srv.device == torch.device("cpu")
        srv.warmup()
        got = [srv.infer(x, timeout=60)[0] for x in xs]
    for g, w, x in zip(got, want, xs):
        assert g.shape == (x.shape[0], 3)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert srv.snapshot()["bucket_compiles"] == \
        jsrv.snapshot()["bucket_compiles"] == 3


def test_forward_feeds_the_same_telemetry_as_jax(exported):
    sym, params = exported
    jp = JaxPredictor(sym, params, {"data": (1, IN)})
    pp = Predictor(sym, params, {"data": (1, IN)}, dev_type="cpu")
    jrts.reset()
    runtime_stats.reset()
    jhistogram.enable()
    histogram.enable()
    for pred in (jp, pp):
        pred.forward(data=_x(1, 0))
        pred.forward(data=_x(1, 1))
    want, got = jrts.snapshot(), runtime_stats.snapshot()
    assert got["counters"]["predictor_forwards"] == \
        want["counters"]["predictor_forwards"] == 2
    assert got["histograms"]["predictor:forward"]["count"] == \
        want["histograms"]["predictor:forward"]["count"] == 2


class _EagerGraph:
    """A stand-in for a CUDA graph on the CPU: a replay runs the captured
    function again and writes its outputs into the captured ones."""

    def __init__(self, fn, outs):
        self.fn, self.outs = fn, outs

    def replay(self):
        with torch.no_grad():
            for o, n in zip(self.outs, self.fn()):
                o.copy_(n)


def test_predict_forward_is_captured_once_a_bound_executor(monkeypatch):
    """One _PredictGraph a bound executor, replayed with the new inputs
    copied into the bound arguments, its outputs copies equal to the
    eager predict forward; a reshaped executor (other arrays) gets its
    own.  The capture itself runs only on the card; here an eager
    stand-in takes its place."""
    def fake_capture(fn, device, pool=None):
        outs = fn()
        return _EagerGraph(fn, outs), outs

    monkeypatch.setattr(_capture, "warm_up", lambda fn, state, dev: fn())
    monkeypatch.setattr(_capture, "capture", fake_capture)
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                name="fc")
    ex = sym.simple_bind(ctx="cpu", grad_req="null", data=(2, IN))
    ex.arg_dict["fc_weight"][:] = mx.nd.array(
        np.random.RandomState(1).rand(3, IN), ctx="cpu")
    ex.capture = True
    for seed in (1, 2, 3):
        x = _x(2, seed)
        got = ex.forward(is_train=False, data=x)[0].asnumpy()
        np.testing.assert_array_equal(
            got, ex._predict()[0].numpy())
    assert len(ex.predict_graphs) == 1
    graph, = ex.predict_graphs.values()
    assert graph.replays == 3 and ex.forward_runs == 3
    out = ex.outputs[0]
    assert out.data_torch.data_ptr() != graph.outs[0].data_ptr()
    other = ex.reshape(data=(4, IN))
    other.capture = True
    other.forward(is_train=False, data=_x(4, 0))
    assert len(other.predict_graphs) == 1 and len(ex.predict_graphs) == 1


def test_float16_data_over_float32_weights_serves_as_jax(exported):
    """``type_dict={"data": "float16"}`` binds float16 data over the
    float32 weights in both packages; the products promote, and the
    float32 outputs agree within 1e-5."""
    sym, params = exported
    jp = JaxPredictor(sym, params, {"data": (3, IN)},
                      type_dict={"data": "float16"})
    pp = Predictor(sym, params, {"data": (3, IN)}, dev_type="cpu",
                   type_dict={"data": "float16"})
    x = _x(3, 5).astype(np.float16)
    for pred in (jp, pp):
        pred.forward(data=x)
    got, want = pp.get_output(0), jp.get_output(0)
    assert got.dtype == np.dtype(want.dtype) == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with InferenceServer(pp, buckets=(4,)) as srv:
        np.testing.assert_allclose(srv.infer(x, timeout=60)[0], want,
                                   rtol=TOL, atol=TOL)
