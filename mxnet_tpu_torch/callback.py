"""Training callbacks of the PyTorch port.

Counterpart of ``mxnet_tpu/callback.py`` (reference:
python/mxnet/callback.py): ``Speedometer``, ``do_checkpoint``,
``module_checkpoint``, ``log_train_metric``, ``ProgressBar`` and
``LogValidationMetricsCallback``, with the reference's log lines
("Epoch[%d] Batch [%d]\tSpeed: ... samples/sec", "Validation-%s=%f").
"""

from __future__ import annotations

import logging
import math
import sys
import time


def _every(period):
    """Normalize an epoch/batch period to a positive int."""
    return max(1, int(period))


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving a Module checkpoint every `period`."""
    period = _every(period)

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving symbol+params every `period` epochs."""
    from .model import save_checkpoint

    period = _every(period)

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every `period`."""
    period = _every(period)

    def _callback(param):
        if param.nbatch % period or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()

    return _callback


class Speedometer:
    """Batch-end callback logging throughput (and metrics) every
    `frequent` batches.

    Speed is measured over the actual window since the previous report
    (the reference assumes the window is exactly `frequent` batches;
    measuring the real batch count is a conscious, more accurate
    divergence — the log format is unchanged).
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = _every(frequent)
        self.auto_reset = auto_reset
        self._window_start = None  # (monotonic time, nbatch) of last mark

    def _restart(self, param):
        self._window_start = (time.monotonic(), param.nbatch)

    def __call__(self, param):
        mark = self._window_start
        # <= catches a new epoch whose nbatch restarts at the mark's own
        # value (e.g. both 0), not just strictly below it
        if mark is None or param.nbatch <= mark[1]:
            self._restart(param)
            return
        if param.nbatch % self.frequent:
            return
        elapsed = time.monotonic() - mark[0]
        batches = param.nbatch - mark[1]
        speed = (batches * self.batch_size / elapsed) if elapsed > 0 \
            else float("inf")
        metric = param.eval_metric
        if metric is None:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)
        else:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            fmt = ("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                   + "\t%s=%f" * len(pairs))
            flat = [x for pair in pairs for x in pair]
            logging.info(fmt, param.epoch, param.nbatch, speed, *flat)
        self._restart(param)


class ProgressBar:
    """Batch-end callback drawing an in-place ASCII bar."""

    def __init__(self, total, length=80):
        self.total = total
        self.bar_len = length

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        fill = int(round(self.bar_len * frac))
        pct = math.ceil(100.0 * frac)
        bar = "=" * fill + "-" * (self.bar_len - fill)
        sys.stdout.write("[%s] %s%%\r" % (bar, pct))


class LogValidationMetricsCallback:
    """Epoch-end callback logging every validation metric."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
