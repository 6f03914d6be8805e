"""The telemetry that the port's serving layer feeds, on the CPU, against
the JAX package: ``histogram`` (snapshots exactly equal on the same
seeded samples, merges associative), ``slo`` (objectives and snapshots
equal after the same stream of requests), ``reqtrace`` (a served
request's record has the JAX record's keys and outcome), the ``serve_*``
counters and the JSONL timeline after the same served load, the runtime
knobs, the ``MXNET_TPU_SERVE_*`` rows as the constructor's defaults, and
the ``log`` helpers.  Both servers serve a callable (``x * 2``) with one
worker and requests sent one at a time, so both form the same batches.
"""

import json
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import histogram as jhistogram
from mxnet_tpu import log as jlog
from mxnet_tpu import reqtrace as jreqtrace
from mxnet_tpu import runtime_stats as jrts
from mxnet_tpu import serving as jserving
from mxnet_tpu import slo as jslo

from mxnet_tpu_torch import histogram, log, reqtrace, runtime_stats, serving
from mxnet_tpu_torch import slo
from mxnet_tpu_torch.serving import InferenceServer, RequestRejected

D = 3  # per-sample width of the served callable


@pytest.fixture(autouse=True)
def _clean_state():
    was = (jhistogram.is_enabled(), histogram.is_enabled())
    jrts.reset()
    runtime_stats.reset()
    yield
    for mod in (jserving, serving):
        for srv in mod.servers():
            srv.stop(drain=False, timeout=5.0)
        mod.reset()
    jrts.reset()
    runtime_stats.reset()
    if not was[0]:
        jhistogram.disable()
    if not was[1]:
        histogram.disable()


def _servers(**kw):
    """The JAX server and the port's, each over ``x * 2``, one worker."""
    jsrv = jserving.InferenceServer(lambda inputs, b: inputs["data"] * 2.0,
                                    {"data": (D,)}, buckets=(1, 2, 4),
                                    workers=1, **kw)
    srv = InferenceServer(lambda inputs, b: inputs["data"] * 2.0,
                          {"data": (D,)}, buckets=(1, 2, 4), workers=1,
                          device="cpu", **kw)
    return jsrv, srv


def _load(srv):
    """One request at a time: 1, 2, 4 rows (full buckets), 3 rows (one pad
    row), a row with a NaN (rejected), a bad shape (refused)."""
    rng = np.random.RandomState(0)
    for n in (1, 2, 4, 3):
        srv.infer(rng.rand(n, D).astype(np.float32), timeout=60)
    bad = rng.rand(1, D).astype(np.float32)
    bad[0, 1] = np.nan
    rejected = (RequestRejected, jserving.RequestRejected)
    with pytest.raises(rejected, match="non-finite"):
        srv.infer(bad, timeout=60)
    with pytest.raises(rejected, match="shape"):
        srv.submit(np.zeros((1, D + 1), np.float32))


# ------------------------------------------------------------ histogram


def _samples(seed):
    rng = np.random.RandomState(seed)
    vals = list(rng.lognormal(-6, 2, size=200)) + [0.0, -1.0, 5e-324]
    rng.shuffle(vals)
    return [float(v) for v in vals]


def test_histogram_snapshot_equals_jax_exactly():
    ours, theirs = histogram.Histogram(), jhistogram.Histogram()
    for v in _samples(1):
        ours.observe(v)
        theirs.observe(v)
    assert ours.snapshot() == theirs.snapshot()
    for q in (0, 1, 37.5, 50, 90, 99, 99.9, 100):
        assert ours.percentile(q) == theirs.percentile(q)
    snaps = [jhistogram.Histogram() for _ in range(3)]
    for i, h in enumerate(snaps):
        for v in _samples(10 + i):
            h.observe(v)
    wire = [json.loads(json.dumps(h.snapshot())) for h in snaps]
    assert histogram.merge_snapshots(wire) == jhistogram.merge_snapshots(wire)


def test_histogram_registry_and_straggler_equal_jax():
    histogram.reset()
    jhistogram.reset()
    histogram.enable()
    jhistogram.enable()
    for i, mult in enumerate((1.0, 1.1, 0.9, 8.0)):
        for v in _samples(i)[:40]:
            histogram.observe("rtt:%d" % i, abs(v) * mult)
            jhistogram.observe("rtt:%d" % i, abs(v) * mult)
    assert histogram.snapshot() == jhistogram.snapshot()
    assert histogram.detect_straggler("rtt:") == \
        jhistogram.detect_straggler("rtt:")
    histogram.disable()
    histogram.observe("rtt:0", 1.0)  # off: nothing recorded
    assert histogram.get("rtt:0").count == 40
    assert runtime_stats.snapshot()["histograms"] == histogram.snapshot()


def test_merge_snapshots_is_associative():
    """Values that are multiples of 2**-12 sum exactly in any order, so
    the folds are equal, not only close."""
    rng = np.random.RandomState(7)
    parts = []
    for _ in range(3):
        h = histogram.Histogram()
        for v in rng.randint(1, 4096, size=50) / 4096.0:
            h.observe(float(v))
        parts.append(h.snapshot())
    a, b, c = parts
    left = histogram.merge_snapshots([histogram.merge_snapshots([a, b]), c])
    right = histogram.merge_snapshots([a, histogram.merge_snapshots([b, c])])
    assert left == right == histogram.merge_snapshots([c, a, b])


# ------------------------------------------------------------------ slo


SLO_SPEC = "e2e:25ms:99.9,avail:99.5,bad:zz:1,, typo:101,fast:0.5s:90"


def _strip_events(objs):
    return [{k: v for k, v in o.items() if k != "events"} for o in objs]


def test_slo_objectives_and_snapshot_equal_jax():
    assert _strip_events(slo.parse_objectives(SLO_SPEC)) == \
        _strip_events(jslo.parse_objectives(SLO_SPEC))
    try:
        assert slo.enable(SLO_SPEC, ring=64) and \
            jslo.enable(SLO_SPEC, ring=64)
        rng = np.random.RandomState(3)
        for _ in range(100):
            latency = float(rng.lognormal(2.5, 1.0))
            ok = bool(rng.rand() > 0.05)
            slo.on_request(latency, ok)
            jslo.on_request(latency, ok)
        slo.on_request(None, False)
        jslo.on_request(None, False)
        assert slo.snapshot() == jslo.snapshot()
    finally:
        slo.reset()
        jslo.reset()
    assert slo.snapshot() == jslo.snapshot() == {"enabled": False}


# ------------------------------------------------------ served telemetry


def test_serve_counters_equal_jax():
    """Every ``serve_*`` counter equal after the same load, but for
    ``serve_bytes_out``: the port copies only the valid rows to the host
    (the JAX server's count has the pad row of the 3-row batch too)."""
    for mod in (slo, jslo):
        mod.enable("e2e:60s:99,avail:99")
    try:
        jsrv, srv = _servers()
        for s in (jsrv, srv):
            with s:
                _load(s)
        want = {k: v for k, v in jrts.snapshot()["counters"].items()
                if k.startswith("serve_")}
        got = {k: v for k, v in runtime_stats.snapshot()["counters"].items()
               if k.startswith("serve_")}
        pad_row_bytes = D * 4
        assert want.pop("serve_bytes_out") - got.pop("serve_bytes_out") \
            == pad_row_bytes
        assert got == want
        assert got["serve_rejected_nonfinite"] == 1
        assert got["serve_rejected_shape"] == 1
        assert got["serve_padded_rows"] == 1
        assert [(o["good"], o["bad"]) for o in slo.snapshot()["objectives"]] \
            == [(o["good"], o["bad"])
                for o in jslo.snapshot()["objectives"]] == [(4, 2), (4, 2)]
        ours, theirs = srv.snapshot(), jsrv.snapshot()
        for key in ("requests", "samples", "batches", "padded_rows",
                    "bucket_compiles", "rejected", "outcomes", "per_bucket",
                    "mean_occupancy"):
            assert ours[key] == theirs[key], key
        assert set(theirs) <= set(ours)
        assert runtime_stats.snapshot()["serving"] == serving.snapshot() \
            == ours  # the stopped server's final snapshot
    finally:
        slo.reset()
        jslo.reset()


def test_reqtrace_records_have_jax_keys_and_outcomes():
    for mod in (reqtrace, jreqtrace):
        mod.reset()
        mod.enable(sample=1)
    try:
        jsrv, srv = _servers()
        for s in (jsrv, srv):
            with s:
                _load(s)
        ours, theirs = reqtrace.snapshot(), jreqtrace.snapshot()
        assert set(ours) == set(theirs)
        for key in ("seen", "retained", "dropped", "by_outcome",
                    "sample_n"):
            assert ours[key] == theirs[key], key
        # a record joins the ring after its caller was answered, so the
        # ring's order may differ between runs: compare by request id
        ring, jring = (sorted(r["ring"], key=lambda rec: rec["rid"])
                       for r in (ours, theirs))
        assert len(ring) == len(jring) == 6
        for a, b in zip(ring, jring):
            assert set(a) == set(b)
            for key in ("rid", "n", "bucket", "pad_rows", "outcome",
                        "retained", "head"):
                assert a[key] == b[key], key
        assert [r["outcome"] for r in ring] == \
            ["ok"] * 4 + ["rejected_nonfinite", "rejected_shape"]
        rid, e2e = reqtrace.exemplar()
        assert e2e > 0 and rid in {r["rid"] for r in ours["ring"]}
    finally:
        reqtrace.reset()
        jreqtrace.reset()


def test_jsonl_lines_have_jax_keys(tmp_path):
    paths = [str(tmp_path / ("%s.jsonl" % who)) for who in ("jax", "port")]
    jsrv = jserving.InferenceServer(lambda inputs, b: inputs["data"] * 2.0,
                                    {"data": (D,)}, buckets=(1, 2, 4),
                                    workers=1, metrics_path=paths[0])
    srv = InferenceServer(lambda inputs, b: inputs["data"] * 2.0,
                          {"data": (D,)}, buckets=(1, 2, 4), workers=1,
                          metrics_path=paths[1], device="cpu")
    lines = []
    for s, path in ((jsrv, paths[0]), (srv, paths[1])):
        with s:
            _load(s)
        with open(path) as f:
            lines.append([json.loads(line) for line in f])
    want, got = lines
    assert len(got) == len(want) == srv.snapshot()["batches"] == 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["bucket"], g["n"], g["step"]) == (w["bucket"], w["n"],
                                                    w["step"])
        assert g["live_bytes"] is None  # no device on the CPU


def test_knobs_grow_and_shrink_the_pool_with_no_request_lost():
    def slow(inputs, bucket):
        time.sleep(0.002)
        return inputs["data"] * 2.0

    srv = InferenceServer(slow, {"data": (D,)}, buckets=(1, 2, 4),
                          workers=1, max_wait_ms=1, device="cpu").start()
    results, errors = [], []

    def client(cid):
        rng = np.random.RandomState(cid)
        try:
            for _ in range(12):
                x = rng.rand(1 + rng.randint(3), D).astype(np.float32)
                results.append((x, srv.submit(x).result(60)[0]))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
    for t in threads:
        t.start()
    try:
        srv.set_workers(3)
        assert srv._worker_count == 3
        srv.set_max_wait_ms(4)
        srv.set_max_queue(512)
        time.sleep(0.05)
        srv.set_workers(1)
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        deadline = time.monotonic() + 10
        while srv._worker_count > 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv._worker_count == 1  # the surplus retired when idle
    finally:
        srv.stop()
    assert not errors and len(results) == 72
    for x, out in results:
        np.testing.assert_array_equal(out, x * 2.0)
    snap = srv.snapshot()
    assert snap["outcomes"]["ok"] == 72 and snap["knob_adjusts"] == 4
    assert [(a["knob"], a["old"], a["new"]) for a in snap["adjustments"]] \
        == [("workers", 1, 3), ("max_wait_ms", 1.0, 4.0),
            ("max_queue", 1024, 512), ("workers", 3, 1)]
    jsrv = jserving.InferenceServer(slow, {"data": (D,)}, workers=1,
                                    max_wait_ms=1).start()
    try:
        for knob, value in (("set_workers", 3), ("set_max_wait_ms", 4),
                            ("set_max_queue", 512), ("set_workers", 1)):
            getattr(jsrv, knob)(value)
    finally:
        jsrv.stop()
    assert [(a["knob"], a["old"], a["new"])
            for a in jsrv.snapshot()["adjustments"]] == \
        [(a["knob"], a["old"], a["new"]) for a in snap["adjustments"]]
    assert runtime_stats.snapshot()["counters"]["serve_knob_adjusts"] == \
        jrts.snapshot()["counters"]["serve_knob_adjusts"] == 4


@pytest.mark.parametrize("row,value,read", [
    ("MXNET_TPU_SERVE_BUCKETS", "4, 1,2", lambda s: s.buckets),
    ("MXNET_TPU_SERVE_BUCKETS", "x", lambda s: s.buckets),
    ("MXNET_TPU_SERVE_QUEUE", "17", lambda s: s.max_queue),
    ("MXNET_TPU_SERVE_WAIT_MS", "7.5", lambda s: s.max_wait),
    ("MXNET_TPU_SERVE_WORKERS", "3", lambda s: s.num_workers),
    ("MXNET_TPU_SERVE_WORKERS", "0", lambda s: s.num_workers),
    ("MXNET_TPU_SERVE_METRICS", "/dev/null", lambda s: s._metrics_path),
    ("MXNET_TPU_SERVE_SENTINEL", "0", lambda s: s._sentinel_on),
])
def test_env_rows_set_the_defaults(monkeypatch, row, value, read):
    monkeypatch.setenv(row, value)
    fn = lambda inputs, b: inputs["data"]  # noqa: E731
    jsrv = jserving.InferenceServer(fn, {"data": (D,)})
    srv = InferenceServer(fn, {"data": (D,)}, device="cpu")
    assert read(srv) == read(jsrv)
    monkeypatch.delenv(row)
    assert read(InferenceServer(fn, {"data": (D,)}, device="cpu")) == \
        read(jserving.InferenceServer(fn, {"data": (D,)}))
    assert serving.WARN_INTERVAL == jserving.WARN_INTERVAL


def test_histograms_env_row_keeps_the_layer_off(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_HISTOGRAMS", "0")
    histogram.disable()
    InferenceServer(lambda inputs, b: inputs["data"], {"data": (D,)},
                    device="cpu")
    assert not histogram.is_enabled()
    monkeypatch.delenv("MXNET_TPU_HISTOGRAMS")
    srv = InferenceServer(lambda inputs, b: inputs["data"], {"data": (D,)},
                          device="cpu")
    assert histogram.is_enabled()
    assert serving.servers()[-1] is srv and serving.snapshot()["running"] \
        is False
    srv.stop()  # never started: leaves the registry
    assert srv not in serving.servers()


def test_served_histograms_have_the_jax_series():
    jsrv, srv = _servers()
    for s in (jsrv, srv):
        with s:
            s.warmup()
            _load(s)
    want, got = jhistogram.snapshot(), histogram.snapshot()
    names = {n for n in want if n.startswith("serve:")}
    assert names == {n for n in got if n.startswith("serve:")}
    assert {"serve:e2e", "serve:queue_wait", "serve:batch",
            "serve:batch:b4", "serve:bucket_build"} <= names
    for name in names:
        assert got[name]["count"] == want[name]["count"], name


# ------------------------------------------------------------------ log


@pytest.mark.parametrize("env", [
    {}, {"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "0"},
    {"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "3", "DMLC_NUM_WORKER": "4"},
    {"DMLC_ROLE": "server", "DMLC_SERVER_ID": "1"},
    {"JAX_PROCESS_ID": "$RANK"},
])
def test_log_identity_and_rank_suffix_equal_jax(monkeypatch, env):
    for k in ("DMLC_ROLE", "DMLC_WORKER_ID", "DMLC_NUM_WORKER",
              "DMLC_SERVER_ID", "MXTPU_PS_SERVER_ID", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert log.process_identity() == jlog.process_identity()
    for path in ("serve.jsonl", "out/trace", "x.worker3.jsonl", ""):
        assert log.rank_suffix_path(path) == jlog.rank_suffix_path(path)


def test_warn_rate_limited_once_an_interval(caplog):
    logger = log.get_logger("mxnet_tpu_torch.test_log")
    logger.propagate = True
    log.reset_rate_limits("t:")
    with caplog.at_level("WARNING", logger="mxnet_tpu_torch.test_log"):
        assert log.warn_rate_limited(logger, "t:a", 60, "one %d", 1)
        assert not log.warn_rate_limited(logger, "t:a", 60, "two")
        assert log.warn_once(logger, "t:b", "three")
        assert not log.warn_once(logger, "t:b", "four")
        log.reset_rate_limits("t:")
        assert log.warn_once(logger, "t:b", "five")
    assert [r.getMessage() for r in caplog.records] == \
        ["one 1", "three", "five"]
    logger.propagate = False


def test_runtime_stats_snapshot_sections():
    runtime_stats.inc("serve_requests", 2)
    runtime_stats.inc("x", 0.5)
    snap = runtime_stats.snapshot()
    assert set(snap) == {"counters", "histograms", "serving", "requests",
                         "slo", "identity"}
    assert snap["counters"] == {"serve_requests": 2, "x": 0.5}
    assert snap["serving"] == {"enabled": False}
    assert snap["requests"] == jrts.snapshot()["requests"]
    runtime_stats.reset()
    assert runtime_stats.snapshot()["counters"] == {}
