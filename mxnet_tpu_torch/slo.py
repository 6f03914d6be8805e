"""Service-level objectives and error budgets of the PyTorch port's
serving path.

Counterpart of ``mxnet_tpu/slo.py``.  Objectives are declared in
``MXNET_TPU_SLO``; the serving layer counts each finished request at its
accounting seams, and :func:`snapshot` evaluates them by the multi-window
burn-rate method (Google SRE workbook): an error budget is
``1 - target``; the burn rate over a window is the window's error rate
over the budget (1.0 spends exactly the budget); an alert needs both a
short and a long window over the threshold, the pairs 5m/1h at 14.4
(fast) and 30m/6h at 6.0 (slow).  ``MXNET_TPU_SLO_WINDOW_SCALE`` scales
every window, so a test can compress hours into milliseconds.

Objective syntax (comma-separated list)::

    MXNET_TPU_SLO=e2e:25ms:99.9,avail:99.5

- ``name:THRESHOLD:TARGET``: a latency objective; a request is bad when
  rejected, failed, or slower than THRESHOLD (``25ms``, ``0.5s``, or a
  bare number of ms).
- ``name:TARGET``: an availability objective; a request is bad when
  rejected or failed.

Callers read ``_state["on"]`` before a call (one dict read a request
while it is off); :func:`on_request` touches host floats only.

Environment variables
---------------------
``MXNET_TPU_SLO``               objective list (see above); empty or
    unset leaves the module off.
``MXNET_TPU_SLO_RING``          events kept an objective (default 4096),
    over which the windows are evaluated.
``MXNET_TPU_SLO_WINDOW_SCALE``  multiplies every window (default 1.0).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from .log import get_logger, warn_rate_limited

__all__ = ["enable", "disable", "is_enabled", "on_request", "snapshot",
           "reset", "parse_objectives", "FAST_BURN", "SLOW_BURN",
           "MIN_EVENTS", "WINDOWS"]

# multi-window pairs: (short, long) seconds, burn threshold, label
FAST_BURN = 14.4
SLOW_BURN = 6.0
MIN_EVENTS = 32  # long-window events needed before a pair may fire
WINDOWS = (("5m", 300.0), ("1h", 3600.0), ("30m", 1800.0),
           ("6h", 21600.0))

# the enable flag: one GIL-atomic dict read on the disabled path
_state = {"on": False, "scale": 1.0, "ring_cap": 4096}
_lock = threading.Lock()
_OBJECTIVES: list = []  # mutated under _lock (enable/reset/on_request)

_logger_cache: list = []


def _logger():
    if not _logger_cache:
        _logger_cache.append(get_logger("mxnet_tpu_torch.slo"))
    return _logger_cache[0]


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


# -------------------------------------------------------------- parsing


def _parse_threshold_ms(tok):
    """``25ms`` / ``0.5s`` / bare number (ms) → float ms, or None."""
    t = tok.strip().lower()
    try:
        if t.endswith("ms"):
            return float(t[:-2])
        if t.endswith("s"):
            return float(t[:-1]) * 1e3
        return float(t)
    except ValueError:
        return None


def parse_objectives(spec):
    """Parse an ``MXNET_TPU_SLO`` value into objective dicts; an invalid
    entry is dropped with a rate-limited warning (a mistyped objective
    must never stop serving)."""
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        toks = part.split(":")
        name = toks[0].strip()
        threshold = None
        target = None
        if len(toks) == 2:
            target = _parse_threshold_ms(toks[1])  # bare percent
        elif len(toks) == 3:
            threshold = _parse_threshold_ms(toks[1])
            target = _parse_threshold_ms(toks[2])
            if threshold is None:
                target = None  # force the invalid branch below
        if not name or target is None or not (0.0 < target < 100.0):
            warn_rate_limited(
                _logger(), "slo:parse:%s" % part, 300,
                "MXNET_TPU_SLO entry %r is not name:THRESHOLD:TARGET "
                "or name:TARGET — dropped", part)
            continue
        out.append({"name": name,
                    "kind": "latency" if threshold is not None
                    else "availability",
                    "threshold_ms": threshold, "target": target / 100.0,
                    "good": 0, "bad": 0, "events": None})
    return out


# ------------------------------------------------------------ lifecycle


def enable(spec=None, ring=None, scale=None):
    """Install objectives (``spec`` beats ``MXNET_TPU_SLO``) and start
    counting.  No valid objective → stays off."""
    raw = os.environ.get("MXNET_TPU_SLO", "") if spec is None else spec
    objs = parse_objectives(raw)
    if not objs:
        return False
    cap = _env_int("MXNET_TPU_SLO_RING", 4096) if ring is None \
        else int(ring)
    cap = max(16, cap)
    sc = _env_float("MXNET_TPU_SLO_WINDOW_SCALE", 1.0) if scale is None \
        else float(scale)
    for ob in objs:
        ob["events"] = deque(maxlen=cap)
    with _lock:
        _OBJECTIVES[:] = objs
        _state["ring_cap"] = cap
        _state["scale"] = sc if sc > 0 else 1.0
    _state["on"] = True
    return True


def disable():
    """Stop counting (objectives and counters are kept; ``reset()``
    drops them)."""
    _state["on"] = False


def is_enabled():
    return _state["on"]


def reset():
    """Disable and drop every objective and counter (tests)."""
    _state["on"] = False
    with _lock:
        _OBJECTIVES[:] = []


# ----------------------------------------------------------- accounting


def on_request(latency_ms, ok):
    """Accounting seam — one call per finished request.  ``ok`` False
    for rejections (queue/shape/nonfinite) and execution errors;
    ``latency_ms`` None when the request never entered the pipeline.
    A latency objective additionally counts an over-threshold
    completion as bad."""
    if not _state["on"]:
        return
    now = time.monotonic()
    with _lock:
        for ob in _OBJECTIVES:
            bad = (not ok) or (ob["threshold_ms"] is not None
                               and latency_ms is not None
                               and latency_ms > ob["threshold_ms"])
            if bad:
                ob["bad"] += 1
            else:
                ob["good"] += 1
            ob["events"].append((now, bad))


# ------------------------------------------------------------ evaluation


def _window_stats(events, now, span):
    """(burn-numerator pieces) over the trailing ``span`` seconds:
    ``(total, bad)`` — events is newest-last, so walk from the tail."""
    total = bad = 0
    for t, b in reversed(events):
        if now - t > span:
            break
        total += 1
        if b:
            bad += 1
    return total, bad


def _evaluate_locked(ob, now, scale):
    budget = 1.0 - ob["target"]
    windows = {}
    for label, span in WINDOWS:
        total, bad = _window_stats(ob["events"], now, span * scale)
        rate = (bad / total) if total else 0.0
        windows[label] = {"seconds": span * scale, "events": total,
                          "bad": bad,
                          "burn": (rate / budget) if budget else 0.0}
    fast = (windows["5m"]["burn"] >= FAST_BURN
            and windows["1h"]["burn"] >= FAST_BURN
            and windows["1h"]["events"] >= MIN_EVENTS)
    slow = (windows["30m"]["burn"] >= SLOW_BURN
            and windows["6h"]["burn"] >= SLOW_BURN
            and windows["6h"]["events"] >= MIN_EVENTS)
    total = ob["good"] + ob["bad"]
    overall = (ob["bad"] / total) if total else 0.0
    remaining = 1.0 - (overall / budget) if budget else 1.0
    return {"name": ob["name"], "kind": ob["kind"],
            "threshold_ms": ob["threshold_ms"],
            "target": ob["target"], "good": ob["good"],
            "bad": ob["bad"], "total": total,
            "budget_remaining": min(1.0, remaining),
            "windows": windows, "fast_burn": fast, "slow_burn": slow}


def snapshot():
    """JSON-ready view with the burn verdicts: each objective's counts,
    remaining budget, windows and ``fast_burn``/``slow_burn``."""
    now = time.monotonic()
    with _lock:
        scale = _state["scale"]
        objs = [_evaluate_locked(ob, now, scale) for ob in _OBJECTIVES]
    if not _state["on"] and not objs:
        return {"enabled": False}
    return {"enabled": _state["on"], "window_scale": scale,
            "ring_cap": _state["ring_cap"], "objectives": objs}


def _activate_from_env():
    """Arming from the environment, called by ``runtime_stats`` at its
    import."""
    if not os.environ.get("MXNET_TPU_SLO"):
        return False
    return enable()
