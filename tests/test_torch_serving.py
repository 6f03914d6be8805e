"""The port's InferenceServer (mxnet_tpu_torch/serving.py) on the CPU,
serving a small TransformerLM: padded buckets against the unbatched
forward (1e-5: the same float32 ops at another batch size), the served
rows of the hybridized model against the JAX package's InferenceServer
over the same weights (1e-4: two packages' float32 products and
softmaxes), one cached graph a bucket, backpressure and shape
rejections, drain on stop, the NaN sentinel for an out-of-range token,
and the static inputs of a hybridized block's graph made as normal
tensors under ``torch.inference_mode()`` (so a graph captured there
replays outside it).
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import histogram, runtime_stats
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.nn.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch import _capture
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.block import _static_inputs
from mxnet_tpu_torch.gluon.nn import TransformerLM
from mxnet_tpu_torch.serving import (InferenceServer, RequestRejected,
                                     ServerStopped)

V, U, L, H, S = 97, 32, 2, 2, 32


def _net(seed=0):
    return TransformerLM(V, units=U, num_layers=L, num_heads=H, max_length=S,
                         device="cpu").initialize(seed=seed)


def _ids(n, seed):
    return np.random.RandomState(seed).randint(0, V, size=(n, S)) \
        .astype(np.float32)


def _unbatched(net, x):
    with torch.inference_mode():
        return net(torch.from_numpy(x)).numpy()


def test_padded_buckets_match_unbatched_forward():
    net = _net()
    with InferenceServer(net, {"data": (S,)}, buckets=(1, 2, 4, 8),
                         device="cpu") as srv:
        for n in (1, 2, 3, 5, 8):
            x = _ids(n, seed=n)
            out = srv.infer(x, timeout=60)
            assert len(out) == 1 and out[0].shape == (n, S, V)
            np.testing.assert_allclose(out[0], _unbatched(net, x),
                                       rtol=1e-5, atol=1e-5)
    snap = srv.snapshot()
    assert snap["requests"] == 5 and snap["samples"] == 19
    assert snap["padded_rows"] >= 4  # 3 -> 4 and 5 -> 8


def test_concurrent_clients_get_their_own_rows():
    net = _net(seed=1)
    results, errors = {}, []
    with InferenceServer(net, {"data": (S,)}, buckets=(1, 2, 4, 8),
                         device="cpu") as srv:
        def client(cid):
            try:
                for i in range(3):
                    x = _ids(1 + (cid + i) % 4, seed=100 * cid + i)
                    results[(cid, i)] = (x, srv.submit(x).result(60)[0])
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 15
    for x, out in results.values():
        np.testing.assert_allclose(out, _unbatched(net, x), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture()
def _jax_serving_state():
    was_on = histogram.is_enabled()
    yield
    for srv in jserving.servers():
        srv.stop(drain=False, timeout=5.0)
    jserving.reset()
    runtime_stats.reset()
    if not was_on:
        histogram.disable()


def test_served_rows_match_jax_server(_jax_serving_state):
    mx.random.seed(5)
    jnet = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S)
    jnet.initialize()
    jnet.hybridize()
    xs = [_ids(n, seed=20 + n) for n in (1, 3, 2)]
    jnet(mx.nd.array(xs[0]))
    with jserving.InferenceServer(jnet, input_shapes={"data": (S,)},
                                  buckets=(1, 2, 4)) as jsrv:
        want = [jsrv.infer(x, timeout=120)[0] for x in xs]
    params = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net = load_mxnet_tpu_params(_net(), params)
    net.hybridize()
    with InferenceServer(net, {"data": (S,)}, buckets=(1, 2, 4),
                         device="cpu") as srv:
        got = [srv.infer(x, timeout=60)[0] for x in xs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert srv.snapshot()["bucket_compiles"] == \
        jsrv.snapshot()["bucket_compiles"] == 3


def test_hybridized_block_has_one_graph_a_bucket():
    """warmup() builds every bucket once (on the CPU a hybridized block's
    graph runs eagerly under its cache key); serving adds none."""
    net, ref = _net(seed=2), _net(seed=2)
    net.hybridize()
    with InferenceServer(net, {"data": (S,)}, buckets=(1, 2, 4),
                         device="cpu") as srv:
        srv.warmup()
        assert srv.snapshot()["bucket_compiles"] == 3
        assert sorted(k[0][0][0][0] for k in net._cached_graphs) == [1, 2, 4]
        for n in (1, 3, 4, 2):
            x = _ids(n, seed=40 + n)
            np.testing.assert_allclose(srv.infer(x, timeout=60)[0],
                                       _unbatched(ref, x), rtol=1e-5,
                                       atol=1e-5)
    assert srv.snapshot()["bucket_compiles"] == 3
    assert len(net._cached_graphs) == 3


@pytest.mark.parametrize("recording", [False, True])
@pytest.mark.parametrize("inference", [False, True])
def test_static_inputs_are_normal_tensors(recording, inference):
    """A graph's static inputs made under inference mode stay normal
    tensors, so a later call's in-place copy outside that mode works;
    the caller's grad mode is kept."""
    args = [torch.rand(2, 3, requires_grad=True), torch.rand(4)]
    with torch.inference_mode(inference):
        grad_before = torch.is_grad_enabled()
        static = _static_inputs(args, recording)
        with _capture.normal_tensors():
            assert torch.is_grad_enabled() == grad_before
            assert not torch.is_inference_mode_enabled()
        assert torch.is_inference_mode_enabled() == inference
    assert not any(t.is_inference() for t in static)
    assert [t.requires_grad for t in static] == [recording, False]
    with torch.no_grad():
        for t, a in zip(static, args):
            t.copy_(a + 1)  # outside inference mode
            assert torch.equal(t, a + 1)
    with torch.inference_mode():
        clone = torch.rand(3).clone()
    with torch.no_grad(), pytest.raises(RuntimeError, match="[Ii]nference"):
        clone.copy_(torch.zeros(3))  # the fault the helper avoids


def test_shape_and_queue_rejections():
    net = _net()
    gate = threading.Event()

    def slow(inputs, bucket):
        gate.wait(30)
        return net(inputs["data"])

    srv = InferenceServer(slow, {"data": (S,)}, buckets=(1, 2), max_queue=3,
                          workers=1, device="cpu").start()
    try:
        with pytest.raises(RequestRejected):
            srv.submit(np.zeros((1, S + 1), np.float32))   # per-sample shape
        with pytest.raises(RequestRejected):
            srv.submit(np.zeros((3, S), np.float32))       # > largest bucket
        with pytest.raises(RequestRejected):
            srv.submit({"tokens": np.zeros((1, S), np.float32)})  # name
        # the model is blocked at the gate: a batch executes, one waits
        # staged, the batcher holds one, then the queue fills up to
        # max_queue samples and backpressure refuses
        futs, refused = [], None
        for i in range(20):
            try:
                futs.append(srv.submit(_ids(1, seed=i)))
            except RequestRejected as e:
                refused = e
                break
        assert refused is not None and "queue full" in str(refused)
        assert 3 <= len(futs) <= 3 + 3 * 2  # queue + three batches in flight
    finally:
        gate.set()
        srv.stop(drain=True)
    for f in futs:
        assert f.result(30)[0].shape == (1, S, V)
    snap = srv.snapshot()
    assert snap["rejected"] == {"queue": 1, "nonfinite": 0, "shape": 3}
    with pytest.raises(RequestRejected, match="stopped"):
        srv.submit(_ids(1, seed=0))


@pytest.mark.parametrize("drain", [True, False])
def test_stop_drains_or_fails_pending(drain):
    net = _net()
    gate = threading.Event()

    def slow(inputs, bucket):
        gate.wait(30)
        return net(inputs["data"])

    srv = InferenceServer(slow, {"data": (S,)}, buckets=(1,), workers=1,
                          device="cpu").start()
    futs = [srv.submit(_ids(1, seed=i)) for i in range(6)]
    stopper = threading.Thread(target=srv.stop, kwargs={"drain": drain})
    stopper.start()
    threading.Event().wait(0.2)
    gate.set()
    stopper.join(60)
    assert not stopper.is_alive()
    served = [f for f in futs if f.done() and f._error is None]
    if drain:
        assert len(served) == 6
    else:
        stopped = [f for f in futs if isinstance(f._error, ServerStopped)]
        assert stopped and len(served) + len(stopped) == 6
        with pytest.raises(ServerStopped):
            stopped[0].result(1)


def test_out_of_range_token_is_rejected_and_neighbours_served():
    net = _net()
    good = _ids(2, seed=1)
    bad = _ids(1, seed=2)
    bad[0, 5] = V + 3
    gate = threading.Event()

    def gated(inputs, bucket):
        gate.wait(30)
        return net(inputs["data"])

    with InferenceServer(gated, {"data": (S,)}, buckets=(4,), max_wait_ms=50,
                         workers=1, device="cpu") as srv:
        plug = srv.submit(_ids(1, seed=3))  # holds the only worker
        for _ in range(200):
            if not srv.queue_depth():
                break
            gate.wait(0.01)
        fb, fg = srv.submit(bad), srv.submit(good)  # one batch together
        gate.set()
        plug.result(60)
        with pytest.raises(RequestRejected, match="non-finite"):
            fb.result(60)
        np.testing.assert_allclose(fg.result(60)[0], _unbatched(net, good),
                                   rtol=1e-5, atol=1e-5)
    snap = srv.snapshot()
    assert snap["rejected"]["nonfinite"] == 1
    assert snap["batches"] == 2 and snap["completed"] == 2


def test_bf16_output_is_served_as_float32_rows():
    """A block whose output is bfloat16: the JAX server hands back bf16
    rows (numpy through ml_dtypes); the port's hands back the same rows
    as float32, as its ``asnumpy()`` does (numpy has no bf16), within one
    bf16 step of the JAX rows (two libraries' bf16 products)."""
    import jax.numpy as jnp

    from mxnet_tpu_torch.gluon.block import HybridBlock
    from mxnet_tpu_torch.gluon.nn import Dense

    rng = np.random.RandomState(5)
    w = rng.randn(6, 4).astype(np.float32)

    class Bf16Head(HybridBlock):
        def __init__(self):
            super().__init__(device="cpu")
            self.dense = Dense(6, in_units=4, use_bias=False, device="cpu")

        def forward(self, x):
            return self.dense(x.to(torch.bfloat16))

    net = Bf16Head()
    with torch.no_grad():
        net.dense._parameters["weight"].copy_(torch.from_numpy(w))
    net.cast("bfloat16")
    x = rng.randn(3, 4).astype(np.float32)
    wj = jnp.asarray(w, jnp.bfloat16)
    with jserving.InferenceServer(
            lambda inputs, bucket: inputs["data"].astype(jnp.bfloat16)
            @ wj.T, {"data": (4,)}, buckets=(4,)) as jsrv:
        want = jsrv.infer(x, timeout=60)[0]
    with InferenceServer(net, {"data": (4,)}, buckets=(4,),
                         device="cpu") as srv:
        got = srv.infer(x, timeout=60)[0]
    assert str(want.dtype) == "bfloat16" and got.dtype == np.float32
    assert got.shape == want.shape == (3, 6)
    want = want.astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -8,
                               atol=2 ** -8 * float(np.abs(want).max()))
