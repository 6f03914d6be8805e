"""Learning-rate schedules of the PyTorch port.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (reference:
python/mxnet/lr_scheduler.py): Factor, MultiFactor, Poly and Cosine
schedules with an optional linear or constant warmup, each a pure
function of the optimizer's update count (``sched(num_update)``), so the
same count gives the same rate in both packages.
"""

from __future__ import annotations

import bisect
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base schedule: optional warmup ramp, then ``_schedule(t)``.

    ``base_lr`` is the post-warmup starting rate; the owning Optimizer
    overwrites it with its own learning_rate at construction.
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_steps < 0:
            raise ValueError("warmup_steps cannot be negative, got %r"
                             % (warmup_steps,))
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("unknown warmup_mode %r (want 'linear' or "
                             "'constant')" % (warmup_mode,))
        if warmup_begin_lr > base_lr:
            raise ValueError("warmup must ramp upward: warmup_begin_lr %r "
                             "exceeds base_lr %r" % (warmup_begin_lr, base_lr))
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_mode = warmup_mode

    # kept as a public method for reference-API parity
    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        frac = num_update / float(self.warmup_steps)
        return self.warmup_begin_lr + frac * (self.base_lr
                                              - self.warmup_begin_lr)

    def _schedule(self, num_update):
        """Post-warmup rate at the ABSOLUTE update count (milestones and
        decay spans are specified in absolute updates, warmup included)."""
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._schedule(num_update)

    @property
    def warmup_final_lr(self):  # reference attribute name
        return self.base_lr


def _check_decay_factor(factor):
    if factor > 1.0:
        raise ValueError("a decay factor > 1 would grow the rate, got %r"
                         % (factor,))


class FactorScheduler(LRScheduler):
    """Geometric decay: rate is ``base_lr * factor**k`` after k complete
    periods of ``step`` updates, floored at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("decay period must be at least 1 update, got %r"
                             % (step,))
        _check_decay_factor(factor)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _schedule(self, num_update):
        periods = max(0, (num_update - 1) // self.step)
        return max(self.stop_factor_lr, self.base_lr * self.factor ** periods)


class MultiFactorScheduler(LRScheduler):
    """Decay by ``factor`` once past each milestone in ``step``."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("milestones must be a non-empty list, got %r"
                             % (step,))
        if any(s < 1 for s in step):
            raise ValueError("milestones must be >= 1, got %r" % (step,))
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must strictly increase, got %r"
                             % (step,))
        _check_decay_factor(factor)
        self.step = step
        self.factor = factor

    def _schedule(self, num_update):
        # number of milestones strictly below the update count
        passed = bisect.bisect_left(self.step, num_update)
        return self.base_lr * self.factor ** passed


class _SpanScheduler(LRScheduler):
    """Shared shape for schedules that interpolate base_lr -> final_lr
    over ``max_update`` total updates (warmup included in the budget)."""

    def __init__(self, max_update, base_lr, final_lr, warmup_steps,
                 warmup_begin_lr, warmup_mode):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive int, got %r"
                             % (max_update,))
        if max_update <= warmup_steps:
            raise ValueError("max_update (%r) must exceed warmup_steps (%r) "
                             "to leave a decay span" % (max_update,
                                                        warmup_steps))
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def _progress(self, num_update):
        """Fraction of the decay span consumed, clamped to [0, 1]."""
        t = num_update - self.warmup_steps
        return min(t, self.max_steps) / float(self.max_steps)

    def _interp(self, weight):
        """final_lr + weight * span, with weight 1 at t=0 decaying to 0."""
        return self.final_lr + (self.base_lr - self.final_lr) * weight


class PolyScheduler(_SpanScheduler):
    """Polynomial decay: weight ``(1 - progress)**pwr``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)
        self.power = pwr

    def _schedule(self, num_update):
        return self._interp((1.0 - self._progress(num_update)) ** self.power)


class CosineScheduler(_SpanScheduler):
    """Half-cosine decay: weight ``(1 + cos(pi * progress)) / 2``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)

    def _schedule(self, num_update):
        return self._interp(
            (1.0 + math.cos(math.pi * self._progress(num_update))) / 2)
