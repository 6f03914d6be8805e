"""``mx.monitor`` (``mx.mon``): statistics of outputs, every few batches.

Counterpart of ``mxnet_tpu/monitor.py:33-127`` (reference:
python/mxnet/monitor.py over MXExecutorSetMonitorCallback).
``Monitor(interval, stat_func=None, pattern=".*", sort=False)`` watches
the batches whose count is a multiple of ``interval`` (``tic`` before
the batch, ``toc`` after it) and returns ``(step, key, value)`` for each
output whose key matches ``pattern``.  :meth:`Monitor.install` takes

- a Gluon block: a forward hook on the block and on each of its
  descendants, keyed ``"<path>_output<i>"`` (the path of a child by its
  structural name, ``"0.1"``; the block itself by its ``name``).  A
  hybridized block's hooks fire on every call; its descendants' only
  while a program is staged (the CPU's eager stand-in, a capture), and
  the Monitor skips those, as the JAX package skips its tracers;
- an :class:`~mxnet_tpu_torch.executor.Executor`, through
  ``set_monitor_callback``: keyed by the symbol's output names.

With no ``stat_func`` the statistic is the JAX package's default, the
mean absolute value in float32, computed on the device when the output is
seen and queued without a sync; ``toc`` fetches the batch's values in one
copy to the host.  An explicit ``stat_func`` gets each output as a numpy
array, one sync each (the reference's semantics).  ``syncs`` counts the
copies to the host.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from . import _capture
from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Output statistics every ``interval`` batches."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func
        self.step = 0
        self.activated = False
        self.queue = []
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.syncs = 0
        self.exes = []

    def install(self, target):
        """Watch ``target``: an Executor or a Gluon block (with its
        descendants).  Returns the Monitor."""
        from .executor import Executor

        if isinstance(target, Executor):
            target.set_monitor_callback(self._stat_helper)
            if not any(e is target for e in self.exes):
                self.exes.append(target)
            return self

        def attach(blk, path):
            blk.register_forward_hook(self._hook(path or blk.name))
            for k, child in blk.named_children():
                attach(child, (path + "." if path else "") + k)

        attach(target, "")
        return self

    def _hook(self, name):
        def hook(blk, inputs, outputs):
            del blk, inputs
            if not self.activated or _capture.is_staging():
                return
            outs = outputs if isinstance(outputs, (list, tuple)) \
                else [outputs]
            for i, o in enumerate(outs):
                key = "%s_output%d" % (name, i)
                if self.re_pattern.match(key) and \
                        isinstance(o, (torch.Tensor, NDArray)):
                    self._observe(key, o)
        return hook

    def _stat_helper(self, name, array):
        if self.activated and self.re_pattern.match(name):
            self._observe(name, array)

    def _observe(self, key, o):
        t = o.data_torch if isinstance(o, NDArray) else o
        if self.stat_func is not None:
            self.syncs += 1
            value = self.stat_func(NDArray(t).asnumpy())
        else:
            with torch.no_grad():
                value = t.detach().float().abs().mean()
        self.queue.append((self.step, key, value))

    def tic(self):
        """Start a batch: watch it when its count is a multiple of
        ``interval``."""
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []
        self.step += 1

    def toc(self):
        """End a watched batch: ``[(step, key, value)]``, the device's
        values fetched in one copy (nothing on a batch not watched)."""
        if not self.activated:
            return []
        self.activated = False
        queued, self.queue = self.queue, []
        device = [i for i, (_, _, v) in enumerate(queued)
                  if isinstance(v, torch.Tensor)]
        res = list(queued)
        if device:
            self.syncs += 1
            host = torch.stack([queued[i][2] for i in device]).cpu().numpy()
            for i, v in zip(device, host):
                res[i] = (queued[i][0], queued[i][1], np.float32(v))
        if self.sort:
            res.sort(key=lambda x: x[1])
        return res

    def toc_print(self):
        for step, name, value in self.toc():
            print("Batch: %7d %30s %s" % (step, name, value))
