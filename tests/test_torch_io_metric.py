"""The port's io, metric, lr_scheduler and initializer against the JAX
package's on the same numpy inputs: NDArrayIter's batches and pads under
every last_batch_handle, MNISTIter's arrays (exactly equal), each metric's
value, each scheduler's rate sequence; the initializers' laws (their
draws come from another generator) and name dispatch."""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError


def _batches(it, epochs=1):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in b.label or []], b.pad,
                        None if b.index is None else list(b.index)))
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[2:] == w[2:]
        for a, b in zip(g[0] + g[1], w[0] + w[1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("form", ["array", "list", "dict"])
def test_ndarray_iter_equals_jax(handle, form):
    rng = np.random.RandomState(0)
    x = rng.randn(10, 3).astype(np.float32)
    x2 = rng.randn(10, 2, 2).astype(np.float32)
    y = rng.randint(0, 4, 10).astype(np.float32)
    data = {"array": x, "list": [x, x2], "dict": {"a": x, "b": x2}}[form]
    its = [mx.io.NDArrayIter(data, y, batch_size=4, last_batch_handle=handle)
           for mx in (tmx, jmx)]
    assert [tuple(d) for d in its[0].provide_data] == \
        [tuple(d) for d in its[1].provide_data]
    assert [tuple(d) for d in its[0].provide_label] == \
        [tuple(d) for d in its[1].provide_label]
    _same(_batches(its[0], 3), _batches(its[1], 3))


def test_ndarray_iter_batches_stay_on_the_host():
    it = tmx.io.NDArrayIter(np.zeros((4, 2), np.float32), batch_size=2)
    b = next(it)
    assert b.data[0].context.type == "cpu" and b.label == []


def test_resize_iter_equals_jax():
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    its = [mx.io.ResizeIter(mx.io.NDArrayIter(x, batch_size=3), 5)
           for mx in (tmx, jmx)]
    _same(_batches(its[0], 2), _batches(its[1], 2))


@pytest.mark.parametrize("kw", [
    {"flat": True}, {"flat": False},
    {"image": "t10k-images-idx3-ubyte", "label": "t10k-labels-idx1-ubyte",
     "flat": False},
    {"flat": True, "num_parts": 3, "part_index": 1}])
def test_mnist_iter_arrays_equal_jax(kw):
    """The synthetic digits (no idx files here) are the same arrays."""
    its = [mx.io.MNISTIter(batch_size=64, shuffle=False, **kw)
           for mx in (tmx, jmx)]
    assert [tuple(d) for d in its[0].provide_data] == \
        [tuple(d) for d in its[1].provide_data]
    got, want = _batches(its[0]), _batches(its[1])
    assert len(got) == (2000 // 64 if "num_parts" in kw
                        else (1000 if "t10k" in kw.get("image", "")
                              else 6000) // 64)
    _same(got, want)


def _metric_inputs():
    rng = np.random.RandomState(1)
    probs = rng.dirichlet(np.ones(5), size=12).astype(np.float32)
    labels = rng.randint(0, 5, 12).astype(np.float32)
    reg = rng.randn(12, 3).astype(np.float32)
    reg_label = rng.randn(12, 3).astype(np.float32)
    return probs, labels, reg, reg_label


METRICS = [
    ("acc", {}, "cls"), ("accuracy", {"axis": 1}, "cls"),
    ("top_k_accuracy", {"top_k": 3}, "cls"), ("ce", {}, "cls"),
    ("nll_loss", {}, "cls"), ("perplexity", {"ignore_label": 2}, "cls"),
    ("perplexity", {}, "cls"), ("mae", {}, "reg"), ("mse", {}, "reg"),
    ("rmse", {}, "reg"), ("loss", {}, "reg"),
]


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=["%s-%d" % (m[0], i)
                              for i, m in enumerate(METRICS)])
def test_metric_equals_jax(name, kw, kind):
    probs, labels, reg, reg_label = _metric_inputs()
    pred, label = (probs, labels) if kind == "cls" else (reg, reg_label)
    values = []
    for mx in (tmx, jmx):
        m = mx.metric.create(name, **kw)
        for lo, hi in ((0, 5), (5, 12)):  # two updates
            m.update([mx.nd.array(label[lo:hi], ctx=mx.cpu())],
                     [mx.nd.array(pred[lo:hi], ctx=mx.cpu())])
        values.append(m.get())
        m.reset()
        values.append(m.get())
    assert values[0][0] == values[2][0]
    np.testing.assert_allclose(values[0][1], values[2][1], rtol=1e-6)
    assert np.isnan(values[1][1]) and np.isnan(values[3][1])


def test_composite_custom_and_np_metrics_equal_jax():
    """The port's composite against the JAX package's metrics one by one
    (the JAX composite raises on cross-entropy's numpy float32 value)."""
    probs, labels, _, _ = _metric_inputs()

    def top_is_label(label, pred):
        return float((pred.argmax(1) == label).sum()), len(label)

    def peak(label, pred):
        return float(pred.max())

    def children(mx):
        return ["acc", "ce", mx.metric.np(top_is_label),
                mx.metric.CustomMetric(peak)]

    comp = tmx.metric.create(children(tmx)[:3])
    comp.add(children(tmx)[3])
    comp.update([tmx.nd.array(labels, ctx="cpu")],
                [tmx.nd.array(probs, ctx="cpu")])
    want = []
    for child in children(jmx):
        m = jmx.metric.create(child)
        m.update([jmx.nd.array(labels)], [jmx.nd.array(probs)])
        want.append(m.get())
    got = comp.get_name_value()
    assert [n for n, _ in got] == [n for n, _ in want] == \
        ["accuracy", "cross-entropy", "top_is_label", "peak"]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-6)
    with pytest.raises(MXNetError, match="not registered"):
        tmx.metric.create("no-such-metric")
    with pytest.raises(ValueError, match="does not match"):
        tmx.metric.Accuracy().update([1, 2], [3])


SCHEDULERS = [
    ("FactorScheduler", {"step": 3, "factor": 0.5, "stop_factor_lr": 0.02}),
    ("FactorScheduler", {"step": 2, "factor": 0.9, "warmup_steps": 4,
                         "warmup_begin_lr": 0.01}),
    ("MultiFactorScheduler", {"step": [3, 7, 12], "factor": 0.1}),
    ("MultiFactorScheduler", {"step": [5], "factor": 0.5, "warmup_steps": 3,
                              "warmup_mode": "constant",
                              "warmup_begin_lr": 0.05}),
    ("PolyScheduler", {"max_update": 15, "pwr": 2, "final_lr": 0.01}),
    ("PolyScheduler", {"max_update": 15, "warmup_steps": 5}),
    ("CosineScheduler", {"max_update": 12, "final_lr": 0.001}),
    ("CosineScheduler", {"max_update": 12, "warmup_steps": 4,
                         "warmup_begin_lr": 0.02}),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=["%s-%d" % (s[0], i)
                              for i, s in enumerate(SCHEDULERS)])
def test_scheduler_sequence_equals_jax(name, kw):
    seqs = []
    for mx in (tmx, jmx):
        sched = getattr(mx.lr_scheduler, name)(base_lr=0.3, **kw)
        seqs.append([sched(t) for t in range(20)])
    assert seqs[0] == seqs[1]


def test_scheduler_errors_as_jax():
    for kw in ({"step": 0}, {"step": 2, "factor": 1.5}):
        with pytest.raises(ValueError):
            tmx.lr_scheduler.FactorScheduler(**kw)
    with pytest.raises(ValueError):
        tmx.lr_scheduler.MultiFactorScheduler(step=[4, 2])
    with pytest.raises(ValueError):
        tmx.lr_scheduler.CosineScheduler(max_update=3, warmup_steps=3)
    with pytest.raises(ValueError):
        tmx.lr_scheduler.PolyScheduler(max_update=10, warmup_mode="cubic")


@pytest.mark.parametrize("rnd_type,factor_type,magnitude", [
    ("uniform", "avg", 3), ("gaussian", "in", 2), ("uniform", "out", 1)])
def test_xavier_law(rnd_type, factor_type, magnitude):
    shape = (64, 32, 3, 3)
    arr = tmx.nd.zeros(shape, ctx="cpu")
    tmx.random.seed(3)
    tmx.init.Xavier(rnd_type, factor_type, magnitude)(
        tmx.init.InitDesc("conv_weight"), arr)
    a = arr.asnumpy()
    fan_in, fan_out = 32 * 9, 64 * 9
    factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = np.sqrt(magnitude / factor)
    if rnd_type == "uniform":
        assert a.min() >= -scale and a.max() <= scale
        np.testing.assert_allclose(a.std(), scale / np.sqrt(3), rtol=0.02)
    else:
        np.testing.assert_allclose(a.std(), scale, rtol=0.02)
    assert abs(a.mean()) < 0.02 * scale
    # the same seed gives the same draws
    again = tmx.nd.zeros(shape, ctx="cpu")
    tmx.random.seed(3)
    tmx.init.create(tmx.init.Xavier(rnd_type, factor_type, magnitude)
                    .dumps())(tmx.init.InitDesc("conv_weight"), again)
    np.testing.assert_array_equal(again.asnumpy(), a)


def test_initializer_name_dispatch_as_jax():
    names = ["fc_weight", "fc_bias", "bn_gamma", "bn_beta",
             "bn_moving_mean", "bn_moving_var", "bn_running_mean",
             "bn_running_var"]
    for name in names:
        got, want = tmx.nd.zeros((3, 2), ctx="cpu"), jmx.nd.zeros((3, 2))
        tmx.init.Constant(0.7)(tmx.init.InitDesc(name), got)
        jmx.init.Constant(0.7)(jmx.init.InitDesc(name), want)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    with pytest.raises(ValueError, match="Unknown initialization"):
        tmx.init.One()(tmx.init.InitDesc("odd_name"),
                       tmx.nd.zeros((2,), ctx="cpu"))
    # a name's __init__ attribute wins over the suffix rule
    arr = tmx.nd.zeros((2, 2), ctx="cpu")
    tmx.init.Zero()(tmx.init.InitDesc("fc_bias", {"__init__": tmx.init.One()
                                                  .dumps()}), arr)
    assert arr.asnumpy().tolist() == [[1.0, 1.0]] * 2
    normal = tmx.nd.zeros((200, 200), ctx="cpu")
    tmx.init.Normal(0.5)(tmx.init.InitDesc("w_weight"), normal)
    np.testing.assert_allclose(normal.asnumpy().std(), 0.5, rtol=0.02)
    assert tmx.init.create("zeros").dumps() == jmx.init.create(
        "zeros").dumps()


def test_callbacks_log_as_jax(caplog, capsys):
    """The callbacks' log lines and progress bar equal the JAX package's
    for the same metric values."""
    import logging

    probs, labels, _, _ = _metric_inputs()
    lines = []
    for mx in (tmx, jmx):
        metric = mx.metric.create("acc")
        metric.update([mx.nd.array(labels, ctx=mx.cpu())],
                      [mx.nd.array(probs, ctx=mx.cpu())])
        param = tmx.module.BatchEndParam(epoch=1, nbatch=4,
                                         eval_metric=metric)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mx.callback.log_train_metric(2)(param)
            mx.callback.LogValidationMetricsCallback()(param)
            mx.callback.ProgressBar(8, length=10)(param)
        lines.append((caplog.messages, capsys.readouterr().out))
    assert lines[0] == lines[1]
    assert lines[0][0] == ["Iter[1] Batch[4] Train-accuracy=%f"
                           % (float((probs.argmax(1) == labels).mean())),
                           "Epoch[1] Validation-accuracy=%f"
                           % (float((probs.argmax(1) == labels).mean()))]
    assert lines[0][1] == "[=====-----] 50%\r"
