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

__all__ = ["inc", "snapshot", "reset", "health_probe"]

# name -> count (trainer_steps, serve_requests, predictor_forwards, ...)
_COUNTERS: dict = {}


def inc(name, delta=1):
    """Bump a named counter (int or float delta)."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + delta


def health_probe():
    """A few dict reads for a checkpoint manifest's probe: the step and
    checkpoint counters and the card's live and peak allocated bytes (0
    on a process that never used CUDA; reading them synchronises
    nothing).  The JAX package's probe also counts compiles and
    fallbacks, which the port does not track; health itself is ROADMAP
    Queue 1 item 10."""
    import torch

    live = peak = 0
    if torch.cuda.is_initialized():
        live = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
    probe = {k: _COUNTERS.get(k, 0) for k in (
        "trainer_steps", "compiled_step_steps", "checkpoint_saves",
        "checkpoint_writes", "checkpoint_restores",
        "checkpoint_corrupt_skipped")}
    probe.update(live_bytes=live, peak_bytes=peak)
    return probe


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
