"""Always-cheap runtime counters of the PyTorch port: the counter core of
``mxnet_tpu/runtime_stats.py``.

Named counters bumped with plain dict increments (GIL-atomic, no lock:
exact on one thread, best effort under concurrency), readable at any
time through :func:`snapshot`, which also carries the latency
histograms (``histogram.py``), the serving layer's stats, the request
x-ray (``reqtrace.py``) and the SLO verdicts (``slo.py``).  Importing
this module arms those layers from the environment, as the JAX
package's does.

Not ported yet (ROADMAP Queue 1 item 12): the per-op dispatch counters
and the recompile-storm detector, the memory and cost sections, the diag
dump and its signal handler, the roofline, the cluster report and the
Prometheus export.
"""

from __future__ import annotations

import sys

from . import histogram as _histogram
from . import reqtrace as _reqtrace
from . import slo as _slo
from .log import process_identity, reset_rate_limits

__all__ = ["inc", "snapshot", "reset"]

# name -> count (trainer_steps, serve_requests, predictor_forwards, ...)
_COUNTERS: dict = {}


def inc(name, delta=1):
    """Bump a named counter (int or float delta)."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + delta


def snapshot():
    """``{"counters", "histograms", "serving", "requests", "slo",
    "identity"}``.  The serving layer is read through ``sys.modules``, so
    a process that never served imports nothing for it."""
    serving = sys.modules.get(__package__ + ".serving")
    return {"counters": dict(_COUNTERS),
            "histograms": _histogram.snapshot(),
            "serving": serving.snapshot() if serving is not None
            else {"enabled": False},
            "requests": _reqtrace.snapshot(),
            "slo": _slo.snapshot(),
            "identity": process_identity()}


def reset():
    """Zero every counter and drop the histograms, request records and
    objectives (tests)."""
    _COUNTERS.clear()
    _histogram.reset()
    _reqtrace.reset()
    _slo.reset()
    reset_rate_limits("slo:")


# arming from the environment, as the JAX package's import does
_histogram._activate_from_env()
_reqtrace._activate_from_env()
_slo._activate_from_env()
