"""Per-request lifecycle tracing of the PyTorch port's serving path
(request x-ray).

Counterpart of ``mxnet_tpu/reqtrace.py``.  Every accepted request gets a
monotonic id and a compact lifecycle record written at the seams
``serving.py`` has (submit, batch join, staging, compute, scatter, done
or rejected): the bucket it rode, the batch id, the pad rows, the queue
depth at submit, the worker that served it and the outcome.

**Tail-based sampling.**  Retention is decided at completion: slow
requests (above ``MXNET_TPU_REQTRACE_SLOW_MS``, or above
``MXNET_TPU_REQTRACE_P99_MULT`` x the rolling p99 once 64 latencies are
in its window), rejected requests and non-finite rejections are always
kept; of the healthy rest a deterministic 1 in N (``rid % N == 0``, the
head sample, decided at submit) is kept.  The JAX package's head-sampled
requests also emit chrome-trace spans linked by profiler flow events
(its ``on_submitted`` seam, and spans at the batch join and the end);
the port has no profiler yet, so it has neither (ROADMAP Queue 1 item
12).

Callers read ``_state["on"]`` before a call (one dict read a request
while it is off); the feeds touch host floats only, never a device
value.  A request's record is written along its lifecycle (the
queue and condition hand-offs order the writes); the ring, the rolling
window and the outcome counters are shared and mutated under ``_lock``.

Environment variables
---------------------
``MXNET_TPU_REQTRACE``          ``1`` enables it when ``runtime_stats`` is
    imported; ``0`` or unset leaves it off.
``MXNET_TPU_REQTRACE_RING``     retained-record ring capacity
    (default 512).
``MXNET_TPU_REQTRACE_SAMPLE``   the head-sample modulus N (default 16;
    ``1`` keeps everything).
``MXNET_TPU_REQTRACE_SLOW_MS``  absolute slow threshold in ms; ``0``
    (default) leaves the rolling-p99 multiple alone.
``MXNET_TPU_REQTRACE_P99_MULT`` a completion is slow past this multiple
    of the rolling p99 (default 3.0).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

__all__ = ["enable", "disable", "is_enabled", "on_submit", "on_reject",
           "on_join", "on_exec", "on_done", "snapshot", "exemplar", "reset"]

# window of recent e2e latencies backing the rolling p99 (and the
# minimum fill before the p99-multiple slow rule may fire)
WINDOW_CAP = 256
WINDOW_WARM = 64
P99_REFRESH = 32  # recompute the cached rolling p99 every N completions

# the enable flag: one GIL-atomic dict read on the disabled path
_state = {"on": False, "ring_cap": 512, "sample_n": 16, "slow_ms": 0.0,
          "p99_mult": 3.0, "p99_ms": None}
_lock = threading.Lock()
_RID = itertools.count(1)   # request ids (next() is GIL-atomic)
_BID = itertools.count(1)   # batch ids, assigned at batch-join
_RING: deque = deque(maxlen=512)      # retained records, under _lock
_WINDOW: deque = deque(maxlen=WINDOW_CAP)  # recent e2e ms, under _lock
_COUNTS: dict = {}                    # outcome -> count, under _lock
_TOTALS = {"seen": 0, "retained": 0, "dropped": 0}  # under _lock

def _env_int(name, default):
    try:
        return int(os.environ.get(name) or default)
    except (TypeError, ValueError):
        return int(default)


def _env_float(name, default):
    try:
        return float(os.environ.get(name) or default)
    except (TypeError, ValueError):
        return float(default)


# ------------------------------------------------------------ lifecycle


def enable(ring=None, sample=None, slow_ms=None, p99_mult=None):
    """Turn request tracing on.  Keyword overrides beat the env knobs;
    the ring is re-sized (existing retained records are kept when the
    capacity is unchanged)."""
    global _RING
    cap = _env_int("MXNET_TPU_REQTRACE_RING", 512) if ring is None \
        else int(ring)
    cap = max(1, cap)
    n = _env_int("MXNET_TPU_REQTRACE_SAMPLE", 16) if sample is None \
        else int(sample)
    n = max(1, n)
    slow = _env_float("MXNET_TPU_REQTRACE_SLOW_MS", 0.0) \
        if slow_ms is None else float(slow_ms)
    mult = _env_float("MXNET_TPU_REQTRACE_P99_MULT", 3.0) \
        if p99_mult is None else float(p99_mult)
    with _lock:
        if cap != _RING.maxlen:
            _RING = deque(_RING, maxlen=cap)
        _state["ring_cap"] = cap
        _state["sample_n"] = n
        _state["slow_ms"] = slow
        _state["p99_mult"] = mult
    _state["on"] = True


def disable():
    """Stop recording (retained records are kept; ``reset()`` drops
    them)."""
    _state["on"] = False


def is_enabled():
    return _state["on"]


def reset():
    """Disable and drop every record, counter and the id counters —
    a fixed workload replayed after ``reset()`` retains the identical
    rid set (tail sampling is deterministic)."""
    global _RID, _BID
    _state["on"] = False
    with _lock:
        _RING.clear()
        _WINDOW.clear()
        _COUNTS.clear()
        _TOTALS["seen"] = 0
        _TOTALS["retained"] = 0
        _TOTALS["dropped"] = 0
        _state["p99_ms"] = None
    _RID = itertools.count(1)
    _BID = itertools.count(1)


# ------------------------------------------------------------ trace feeds


def on_submit(req, depth):
    """Submit seam: assign the request id, open its lifecycle record
    (queue depth observed at submit), and make the deterministic head
    decision.  Runs on the client thread, before the batcher can see
    the request (the caller holds the server condvar), so every later
    seam finds ``req.trace`` set.  It touches nothing beyond the request
    object."""
    if not _state["on"]:
        return
    rid = next(_RID)
    head = (rid % _state["sample_n"] == 0)
    req.rid = rid
    req.trace = {"rid": rid, "n": req.n, "queue_depth": depth,
                 "head": head, "t_submit": req.t_submit,
                 "bucket": None, "batch": None, "worker": None,
                 "pad_rows": None, "outcome": None}


def on_reject(kind, n=0):
    """Rejection at the front door (queue-full / shape): the request
    never enters the pipeline, but it must not vanish from accounting —
    record a degenerate always-retained lifecycle with the reject kind
    as its outcome."""
    if not _state["on"]:
        return
    rid = next(_RID)
    rec = {"rid": rid, "n": n, "queue_depth": None, "head": False,
           "bucket": None, "batch": None, "worker": None,
           "pad_rows": None, "outcome": kind, "retained": kind,
           "e2e_ms": 0.0, "queue_ms": None, "stage_ms": None,
           "compute_ms": None, "scatter_ms": None}
    with _lock:
        _TOTALS["seen"] += 1
        _TOTALS["retained"] += 1
        _COUNTS[kind] = _COUNTS.get(kind, 0) + 1
        _RING.append(rec)


def on_join(reqs, bucket):
    """Batch-join seam (batcher thread): stamp the bucket and a fresh
    batch id on every member."""
    if not _state["on"]:
        return
    bid = next(_BID)
    for r in reqs:
        tr = getattr(r, "trace", None)
        if tr is None:
            continue
        tr["bucket"] = bucket
        tr["batch"] = bid
        tr["t_batched"] = r.t_batched


def on_exec(reqs, worker, pad_rows, t_staged, t_compute):
    """Execution seam (worker thread, once per batch after the fetch
    host-sync): stamp the worker, the batch's pad-row count and the
    staging/compute boundary times on every member's record."""
    if not _state["on"]:
        return
    for r in reqs:
        tr = getattr(r, "trace", None)
        if tr is None:
            continue
        tr["worker"] = worker
        tr["pad_rows"] = pad_rows
        tr["t_staged"] = t_staged
        tr["t_compute"] = t_compute


def on_done(req, outcome, t_done=None):
    """Completion seam (worker thread): finalize the record — derive
    the per-seam millisecond ladder, make the tail retention decision
    (always keep non-``ok`` outcomes and slow completions, else the
    deterministic head sample)."""
    if not _state["on"]:
        return
    tr = getattr(req, "trace", None)
    if tr is None:
        return
    now = time.perf_counter() if t_done is None else t_done
    t_submit = tr.pop("t_submit")
    t_batched = tr.pop("t_batched", None)
    t_staged = tr.pop("t_staged", None)
    t_compute = tr.pop("t_compute", None)
    e2e_ms = (now - t_submit) * 1e3
    tr["e2e_ms"] = e2e_ms
    tr["queue_ms"] = None if t_batched is None \
        else (t_batched - t_submit) * 1e3
    tr["stage_ms"] = None if t_staged is None or t_batched is None \
        else (t_staged - t_batched) * 1e3
    tr["compute_ms"] = None if t_compute is None or t_staged is None \
        else (t_compute - t_staged) * 1e3
    tr["scatter_ms"] = None if t_compute is None \
        else (now - t_compute) * 1e3
    tr["outcome"] = outcome
    slow_ms = _state["slow_ms"]
    mult = _state["p99_mult"]
    with _lock:
        _TOTALS["seen"] += 1
        _COUNTS[outcome] = _COUNTS.get(outcome, 0) + 1
        _WINDOW.append(e2e_ms)
        if _state["p99_ms"] is None \
                or _TOTALS["seen"] % P99_REFRESH == 0:
            w = sorted(_WINDOW)
            _state["p99_ms"] = w[min(len(w) - 1,
                                     int(len(w) * 0.99))]
        p99 = _state["p99_ms"]
        why = None
        if outcome != "ok":
            why = outcome
        elif slow_ms and e2e_ms >= slow_ms:
            why = "slow"
        elif p99 is not None and len(_WINDOW) >= WINDOW_WARM \
                and e2e_ms >= mult * p99:
            why = "slow"
        elif tr["head"]:
            why = "head"
        if why is None:
            _TOTALS["dropped"] += 1
        else:
            tr["retained"] = why
            _TOTALS["retained"] += 1
            _RING.append(tr)


# ------------------------------------------------------------- snapshots


def snapshot():
    """JSON-ready view: sampling config, totals, per-outcome counts,
    the rolling p99 and every retained record (oldest first)."""
    with _lock:
        ring = [dict(r) for r in _RING]
        counts = dict(_COUNTS)
        totals = dict(_TOTALS)
        p99 = _state["p99_ms"]
    if not _state["on"] and not totals["seen"]:
        return {"enabled": False}
    return {"enabled": _state["on"], "ring_cap": _state["ring_cap"],
            "sample_n": _state["sample_n"],
            "slow_ms": _state["slow_ms"],
            "p99_mult": _state["p99_mult"], "rolling_p99_ms": p99,
            "seen": totals["seen"], "retained": totals["retained"],
            "dropped": totals["dropped"], "by_outcome": counts,
            "ring": ring}


def exemplar():
    """``(rid, e2e_seconds)`` of the slowest retained completion, or
    None."""
    with _lock:
        worst = None
        for r in _RING:
            e2e = r.get("e2e_ms")
            if e2e and (worst is None or e2e > worst["e2e_ms"]):
                worst = r
    if worst is None:
        return None
    return (worst["rid"], worst["e2e_ms"] / 1e3)


def _activate_from_env():
    """Arming from the environment, called by ``runtime_stats`` at its
    import."""
    flag = os.environ.get("MXNET_TPU_REQTRACE")
    if not flag or flag == "0":
        return False
    enable()
    return True
