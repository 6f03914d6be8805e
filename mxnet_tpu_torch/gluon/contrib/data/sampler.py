"""Dataset samplers (reference: python/mxnet/gluon/contrib/data/
sampler.py; ``mxnet_tpu/gluon/contrib/data/sampler.py``)."""

from __future__ import annotations

from ...data import sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(sampler.Sampler):
    """``[0, length)`` at steps of ``interval``; with ``rollover``, again
    from each skipped offset until every item is visited."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError("Interval %d must be <= length %d"
                             % (interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length
