"""Lock-free log2-bucketed latency histograms of the PyTorch port.

Counterpart of ``mxnet_tpu/histogram.py``.  ``runtime_stats`` counts how
often things happen; this module records how long they take, as whole
distributions.  One histogram is a dict of power-of-two buckets
(``frexp`` exponent -> count: bucket ``e`` covers ``[2^(e-1), 2^e)``
seconds) with an exact count, sum, min and max.  Every mutation is a
plain GIL-atomic dict or attribute update, no lock (exact on one thread,
best effort under concurrency).  A percentile is interpolated by rank
inside the bucket that holds it, the bucket's bounds tightened by the
exact min and max, so samples that share one value report it exactly
and any percentile lies within a factor of 2 of the order statistic.
Histograms merge associatively (bucket counts add), so per-process
snapshots fold into one.

Fed in the port by the serving layer (``serve:queue_wait``, ``serve:e2e``,
``serve:batch``, ``serve:batch:b<B>``, ``serve:bucket_build``) and the
``Predictor`` (``predictor:forward``); callers on hot paths read
``_state["on"]`` before they take a timestamp.

Environment variables
---------------------
``MXNET_TPU_HISTOGRAMS``  ``1`` enables collection when ``runtime_stats``
    is imported, ``0`` keeps it off (a server then leaves it off too);
    unset, it is enabled when ``MXNET_TPU_PROFILE`` or ``MXNET_TPU_DIAG``
    is set.
``MXNET_TPU_STRAGGLER_RATIO``  a member is a straggler when its p99
    exceeds this multiple of the median p99 of the others (default 3).
``MXNET_TPU_STRAGGLER_MIN_SAMPLES``  observations each member needs
    before :func:`detect_straggler` answers (default 32).
``MXNET_TPU_STRAGGLER_INTERVAL``  minimum seconds between straggler
    warnings (default 60).
"""

from __future__ import annotations

import math
import os

__all__ = ["Histogram", "enable", "disable", "is_enabled", "observe",
           "get", "snapshot", "reset", "merge_snapshots",
           "detect_straggler", "bucket_index", "bucket_bounds"]

# straggler-detection knobs (module attrs so tests can monkeypatch)
STRAGGLER_RATIO = float(os.environ.get("MXNET_TPU_STRAGGLER_RATIO", "3"))
STRAGGLER_MIN_SAMPLES = int(os.environ.get(
    "MXNET_TPU_STRAGGLER_MIN_SAMPLES", "32"))
STRAGGLER_WARN_INTERVAL = float(os.environ.get(
    "MXNET_TPU_STRAGGLER_INTERVAL", "60"))

# bucket for values <= 0 (a degenerate but legal observation): below
# every subnormal exponent, so it always sorts first
_ZERO_BUCKET = -1100

# the enable flag: one GIL-atomic dict read on the disabled path
_state = {"on": False}
# name -> Histogram; mutated with GIL-atomic ops only (a lost increment
# under concurrent observe() is accepted noise)
_HISTS: dict = {}


def bucket_index(value):
    """Bucket exponent for ``value``: the ``e`` with ``value`` in
    ``[2^(e-1), 2^e)`` (``frexp``'s exponent), or the zero bucket for
    values <= 0."""
    if value <= 0.0:
        return _ZERO_BUCKET
    return math.frexp(value)[1]


def bucket_bounds(index):
    """``(lo, hi)`` seconds covered by bucket ``index``."""
    if index == _ZERO_BUCKET:
        return (0.0, 0.0)
    return (math.ldexp(0.5, index), math.ldexp(1.0, index))


class Histogram:
    """One log2-bucketed distribution with exact count/sum/min/max.

    Mutation is lock-free (GIL-atomic increments); reads
    (:meth:`snapshot`, :meth:`percentile`) copy the bucket dict first,
    so a concurrent observe can never torn-read a derived stat."""

    __slots__ = ("buckets", "count", "total", "min", "max")

    def __init__(self):
        self.buckets = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    def observe(self, value):
        """Record one sample (seconds)."""
        b = bucket_index(value)
        buckets = self.buckets
        buckets[b] = buckets.get(b, 0) + 1
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def merge(self, other):
        """Fold ``other`` (a Histogram) into this one — associative and
        commutative up to float-sum rounding, the property the
        cross-rank merge relies on."""
        for b, c in list(other.buckets.items()):
            self.buckets[b] = self.buckets.get(b, 0) + c
        self.count += other.count
        self.total += other.total
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        return self

    def percentile(self, q):
        """Derived q-th percentile: rank interpolation inside the
        bucket holding rank ``q/100 * count``, with bucket bounds
        tightened by the exact min/max (all-equal samples → exact)."""
        count = self.count
        if not count:
            return None
        buckets = dict(self.buckets)
        target = count * q / 100.0
        cum = 0.0
        for b in sorted(buckets):
            c = buckets[b]
            nxt = cum + c
            if nxt >= target:
                lo, hi = bucket_bounds(b)
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi < lo:
                    hi = lo
                frac = (target - cum) / c if c else 1.0
                return lo + (hi - lo) * frac
            cum = nxt
        return self.max

    def snapshot(self):
        """JSON-ready dict: exact count/sum/min/max, derived mean and
        p50/p90/p99, and the raw buckets (for merging)."""
        count = self.count
        out = {"count": count, "sum": self.total,
               "min": self.min if count else None,
               "max": self.max if count else None,
               "mean": (self.total / count) if count else None,
               "buckets": {str(b): c for b, c in list(self.buckets.items())}}
        for q, key in ((50, "p50"), (90, "p90"), (99, "p99")):
            out[key] = self.percentile(q)
        return out

    @classmethod
    def from_snapshot(cls, snap):
        """Rebuild a mergeable Histogram from :meth:`snapshot` output
        (bucket keys may be strings after a JSON round-trip)."""
        h = cls()
        h.buckets = {int(b): int(c)
                     for b, c in (snap.get("buckets") or {}).items()}
        h.count = int(snap.get("count", 0))
        h.total = float(snap.get("sum", 0.0))
        if h.count:
            h.min = float(snap["min"]) if snap.get("min") is not None \
                else math.inf
            h.max = float(snap["max"]) if snap.get("max") is not None \
                else 0.0
        return h


def merge_snapshots(snaps):
    """Merge a list of :meth:`Histogram.snapshot` dicts (possibly
    JSON-round-tripped) into one snapshot dict — the per-rank →
    cluster fold."""
    merged = Histogram()
    for s in snaps:
        merged.merge(Histogram.from_snapshot(s))
    return merged.snapshot()


# ------------------------------------------------------------ registry


def enable():
    """Turn collection on.  (The JAX package's also raises its dispatch
    layer's cache-warm timing, which the port does not have.)"""
    _state["on"] = True


def disable():
    """Turn collection off (existing histograms are kept; ``reset()``
    drops them)."""
    _state["on"] = False


def is_enabled():
    return _state["on"]


def get(name):
    """The named histogram (created on first use)."""
    h = _HISTS.get(name)
    if h is None:
        h = _HISTS[name] = Histogram()
    return h


def observe(name, value):
    """Record one sample into the named histogram — ONE dict read and
    nothing else while collection is off (callers on hot paths guard on
    ``_state["on"]`` themselves before taking timestamps)."""
    if not _state["on"]:
        return
    h = _HISTS.get(name)
    if h is None:
        h = _HISTS[name] = Histogram()
    h.observe(value)


def snapshot():
    """``{name: histogram-snapshot-dict}`` for every live histogram."""
    return {name: h.snapshot() for name, h in list(_HISTS.items())}


def reset():
    """Drop every histogram (tests)."""
    _HISTS.clear()


# --------------------------------------------------- straggler detection


def median_of_others(p99s, worst_name):
    """Median p99 of every group member EXCEPT the worst.  Comparing
    the worst against the median *including itself* caps the
    detectable ratio at 2x for two-member groups (the worst drags its
    own baseline up); excluding it keeps one straggler detectable at
    any group size."""
    import statistics

    others = [p for n, p in p99s if n != worst_name]
    return statistics.median(others) if others else None


def detect_straggler(prefix, min_samples=None, ratio=None):
    """Among live histograms whose name starts with ``prefix`` (one per
    shard/rank), return ``{"name", "p99", "median_p99", "ratio"}`` for
    the slowest when its p99 exceeds ``ratio`` × the median p99 of the
    OTHER members — else None.  Needs >= 2 group members with at least
    ``min_samples`` observations each."""
    min_samples = STRAGGLER_MIN_SAMPLES if min_samples is None \
        else min_samples
    ratio = STRAGGLER_RATIO if ratio is None else ratio
    group = [(name, h) for name, h in list(_HISTS.items())
             if name.startswith(prefix) and h.count >= min_samples]
    if len(group) < 2:
        return None
    p99s = [(name, h.percentile(99)) for name, h in group]
    p99s = [(n, p) for n, p in p99s if p is not None]
    if len(p99s) < 2:
        return None
    worst_name, worst = max(p99s, key=lambda np_: np_[1])
    med = median_of_others(p99s, worst_name)
    if not med or med <= 0 or worst <= ratio * med:
        return None
    return {"name": worst_name, "p99": worst, "median_p99": med,
            "ratio": worst / med}


def _activate_from_env():
    """Arming from the environment, called by ``runtime_stats`` at its
    import."""
    flag = os.environ.get("MXNET_TPU_HISTOGRAMS")
    if flag == "0":
        return False
    if flag == "1" or os.environ.get("MXNET_TPU_PROFILE") \
            or os.environ.get("MXNET_TPU_DIAG"):
        enable()
        return True
    return False
