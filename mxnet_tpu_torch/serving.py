"""Continuous-batching inference server of the PyTorch port.

Counterpart of ``mxnet_tpu/serving.py`` (``InferenceServer``): a
thread-safe request queue in front of a loaded model; a batcher thread
packs whole requests into bucketed batch shapes (a ladder, default
1/2/4/8/16, zero-padded to the bucket, the pad rows masked out of the
scatter); a small worker pool stages each batch onto the device, runs the
model and scatters the rows back.  A full queue rejects at submit
(explicit backpressure), :meth:`InferenceServer.stop` drains accepted
requests, and a row with a NaN or infinity in any output is rejected with
:class:`RequestRejected`, never returned.

What differs from the JAX package:

- Each batch runs under ``torch.inference_mode()`` on its worker thread:
  grad mode is thread-local in PyTorch, so a mode set by the caller's
  thread would not reach the workers.
- The one host sync is the ``.cpu()`` of the outputs on the worker (the
  JAX package's ``_fetch``); the non-finite check runs on the device
  before it and only the valid rows travel to the host.
- The telemetry layers the JAX server feeds (histograms, runtime stats,
  request traces, SLOs, autopilot, health, device memory) are not ported
  yet; the server keeps a plain ``stats`` dict.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

import numpy as np
import torch

from .context import resolve_device

__all__ = ["InferenceServer", "RequestRejected", "ServerStopped",
           "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

_log = logging.getLogger("mxnet_tpu_torch.serving")


class RequestRejected(RuntimeError):
    """The server refused (queue full, bad shape) or rejected (non-finite
    output) this request."""


class ServerStopped(RuntimeError):
    """The server stopped without serving this request
    (``stop(drain=False)``)."""


class _Request:
    """One queued request: named input arrays with a leading sample axis,
    and the future the caller waits on."""

    __slots__ = ("inputs", "n", "t_submit", "t_batched", "t_done",
                 "_event", "_outputs", "_error")

    def __init__(self, inputs, n):
        self.inputs = inputs
        self.n = n
        self.t_submit = time.perf_counter()
        self.t_batched = None
        self.t_done = None
        self._event = threading.Event()
        self._outputs = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block until served; the list of per-output numpy arrays
        (leading axis = this request's sample count).  Raises
        :class:`RequestRejected` / :class:`ServerStopped` on rejection."""
        if not self._event.wait(timeout):
            raise TimeoutError("inference request not served within %.3fs"
                               % timeout)
        if self._error is not None:
            raise self._error
        return self._outputs

    def _finish(self):
        self.t_done = time.perf_counter()
        self._event.set()

    def _complete(self, outputs):
        self._outputs = outputs
        self._finish()

    def _fail(self, error):
        self._error = error
        self._finish()


# --------------------------------------------------------- model adapters


class _BlockModel:
    """Batches through a port block (an ``nn.Module``) with one input.
    Calls are serialized under one lock, as in the JAX package."""

    def __init__(self, block, sample_shape, input_name):
        self._block = block
        self._lock = threading.Lock()
        self.input_names = [input_name]
        self.sample_shapes = {input_name: tuple(sample_shape)}

    def run(self, inputs, bucket):
        del bucket  # one eager module serves every bucket
        with self._lock:
            out = self._block(inputs[self.input_names[0]])
        return list(out) if isinstance(out, (list, tuple)) else [out]


class _CallableModel:
    """Batches through a callable ``fn(inputs, bucket) -> output(s)``
    (tensors in, tensors out)."""

    def __init__(self, fn, input_shapes):
        self._fn = fn
        self.input_names = list(input_shapes)
        self.sample_shapes = {n: tuple(s) for n, s in input_shapes.items()}

    def run(self, inputs, bucket):
        out = self._fn(inputs, bucket)
        return list(out) if isinstance(out, (list, tuple)) else [out]


def _adapt(model, input_shapes):
    if not input_shapes:
        raise ValueError("the model needs input_shapes "
                         "({name: per-sample shape})")
    if not isinstance(model, torch.nn.Module):
        return _CallableModel(model, input_shapes)
    if len(input_shapes) != 1:
        raise ValueError("block serving supports exactly one input")
    (name, shape), = input_shapes.items()
    return _BlockModel(model, shape, name)


# --------------------------------------------------------------- server


class InferenceServer:
    """Continuous-batching inference server over a loaded model.

    Parameters
    ----------
    model : port block (``nn.Module``) or callable
        A block takes one input; a callable is ``fn(inputs, bucket)``.
    input_shapes : dict
        ``{name: per-sample shape}`` (no batch axis).  Requests arrive as
        float32 (the JAX package passes no dtype for a block either), so
        a language model's token ids are exact below 2**24.
    buckets : tuple of int
        Batch-size ladder; the largest bucket caps a request's samples.
    max_wait_ms, max_queue, workers
        Batch-formation wait while every worker is busy, bound on queued
        samples, pipeline worker threads.
    device
        Where batches run; ``None`` means ``gpu(0)``.  A block must live
        on this device.
    """

    def __init__(self, model, input_shapes=None, buckets=None,
                 max_wait_ms=2.0, max_queue=1024, workers=2, device=None):
        self.device = resolve_device(device)
        if isinstance(model, torch.nn.Module):
            p = next(model.parameters(), None)
            if p is not None and p.device != self.device:
                raise ValueError("the model lives on %s, the server on %s"
                                 % (p.device, self.device))
        self._model = _adapt(model, input_shapes)
        self.buckets = tuple(sorted(set(buckets or DEFAULT_BUCKETS)))
        if not self.buckets or any(b <= 0 for b in self.buckets):
            raise ValueError("buckets must be positive ints")
        self.max_bucket = self.buckets[-1]
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.num_workers = max(1, int(workers))

        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._queued_samples = 0    # under _cond
        self._inflight = 0          # under _cond
        self._stopping = False      # set under _cond, re-checked under it
        self._running = False
        self._threads: list = []
        self._batchq: collections.deque = collections.deque()
        self._batch_cond = threading.Condition()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "samples": 0, "batches": 0,
                      "padded_rows": 0, "rejected_queue": 0,
                      "rejected_nonfinite": 0, "rejected_shape": 0,
                      "completed": 0, "errors": 0,
                      "per_bucket": {b: {"batches": 0, "samples": 0}
                                     for b in self.buckets}}

    # ----------------------------------------------------------- lifecycle
    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop(drain=exc_type is None)
        return False

    def start(self):
        """Start the batcher and worker threads (idempotent)."""
        if self._running:
            return self
        self._stopping = False
        self._running = True
        t = threading.Thread(target=self._batcher_loop,
                             name="mxt-serve-batcher", daemon=True)
        t.start()
        self._threads = [t]
        for i in range(self.num_workers):
            w = threading.Thread(target=self._worker_loop,
                                 name="mxt-serve-worker-%d" % i, daemon=True)
            w.start()
            self._threads.append(w)
        return self

    def stop(self, drain=True, timeout=60.0):
        """Stop the server.  ``drain=True`` serves every accepted request
        first; ``drain=False`` fails pending requests with
        :class:`ServerStopped`.  New submissions are refused either way."""
        if not self._running:
            return
        with self._cond:
            self._stopping = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    self._queued_samples -= req.n
                    req._fail(ServerStopped("server stopped before "
                                            "serving this request"))
            self._cond.notify_all()
        with self._batch_cond:
            self._batch_cond.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._running = False

    def warmup(self):
        """Run one all-zeros batch through every bucket, so the first real
        request pays no first-call cost (kernel build, cuBLAS setup)."""
        for b in self.buckets:
            inputs = {n: self._stage(np.zeros((b,) + s, np.float32))
                      for n, s in self._model.sample_shapes.items()}
            with torch.inference_mode():
                self._fetch(self._model.run(inputs, b), b)
        return self

    # ------------------------------------------------------------- submit
    def submit(self, inputs):
        """Queue one request; returns a future with ``result(timeout)``.

        ``inputs``: one array (single-input models) or ``{name: array}``;
        each array carries a leading sample axis ``k`` (1 <= k <= the
        largest bucket).  Raises :class:`RequestRejected` at once on a
        full queue or a shape or name mismatch."""
        named = self._validate(inputs)
        n = next(iter(named.values())).shape[0]
        req = _Request(named, n)
        with self._cond:
            if self._stopping or not self._running:
                raise RequestRejected("server is not accepting requests "
                                      "(stopped)")
            if self._queued_samples + n > self.max_queue:
                self._count_reject("rejected_queue")
                raise RequestRejected(
                    "queue full (%d queued samples, max %d) — backpressure;"
                    " retry or add capacity" % (self._queued_samples,
                                               self.max_queue))
            self._queue.append(req)
            self._queued_samples += n
            self._cond.notify()
        return req

    def infer(self, inputs, timeout=60.0):
        """Blocking convenience: ``submit(inputs).result(timeout)``."""
        return self.submit(inputs).result(timeout)

    def _validate(self, inputs):
        shapes = self._model.sample_shapes
        if not isinstance(inputs, dict):
            if len(shapes) != 1:
                raise RequestRejected("model has inputs %s — pass a "
                                      "{name: array} dict" % sorted(shapes))
            inputs = {next(iter(shapes)): inputs}
        if set(inputs) != set(shapes):
            self._count_reject("rejected_shape")
            raise RequestRejected("request inputs %s != model inputs %s"
                                  % (sorted(inputs), sorted(shapes)))
        named = {}
        n = None
        for name, arr in inputs.items():
            arr = np.asarray(arr, dtype=np.float32, order="C")
            want = shapes[name]
            if arr.ndim != len(want) + 1 or tuple(arr.shape[1:]) != want:
                self._count_reject("rejected_shape")
                raise RequestRejected(
                    "input %r shape %s != (k,)+%s — requests carry an "
                    "explicit leading sample axis" % (name, arr.shape, want))
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                self._count_reject("rejected_shape")
                raise RequestRejected("inconsistent sample counts across "
                                      "inputs")
            named[name] = arr
        if not n or n > self.max_bucket:
            self._count_reject("rejected_shape")
            raise RequestRejected(
                "request sample count %s outside 1..%d (the largest bucket)"
                " — split large requests client-side" % (n, self.max_bucket))
        return named

    def _count_reject(self, kind):
        with self._stats_lock:
            self.stats[kind] += 1

    # ------------------------------------------------------------ batching
    def _bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_bucket

    def _batcher_loop(self):
        """Pack whole queued requests up to the largest bucket; dispatch
        at once when the bucket is full or a worker is idle, else wait up
        to ``max_wait`` for more arrivals."""
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if not self._queue:
                    break  # stopping and fully drained
                picked, total = self._pick_locked([], 0)
                deadline = time.perf_counter() + self.max_wait
                while total < self.max_bucket and not self._stopping:
                    if self._inflight < self.num_workers \
                            and not self._batchq:
                        break  # an idle worker: serve what we have now
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                    picked, total = self._pick_locked(picked, total)
                self._inflight += 1
            bucket = self._bucket_for(total)
            now = time.perf_counter()
            for r in picked:
                r.t_batched = now
            with self._batch_cond:
                # at most one staged batch per worker, so accepted
                # requests stay in the accounted queue and max_queue
                # bounds the backlog
                while len(self._batchq) >= self.num_workers:
                    self._batch_cond.wait(timeout=0.05)
                self._batchq.append((picked, total, bucket))
                self._batch_cond.notify()
        with self._batch_cond:
            self._batch_cond.notify_all()

    def _pick_locked(self, picked, total):
        while self._queue and total + self._queue[0].n <= self.max_bucket:
            r = self._queue.popleft()
            self._queued_samples -= r.n
            picked.append(r)
            total += r.n
        return picked, total

    # ------------------------------------------------------------- workers
    def _worker_loop(self):
        while True:
            with self._batch_cond:
                while not self._batchq:
                    if self._stopping and not self._threads[0].is_alive():
                        return
                    self._batch_cond.wait(timeout=0.1)
                picked, total, bucket = self._batchq.popleft()
                self._batch_cond.notify_all()
            try:
                self._serve_batch(picked, total, bucket)
            except Exception as e:  # a bad batch must not kill the pool
                _log.exception("serving batch failed")
                failed = 0
                for r in picked:
                    if not r.done():
                        r._fail(RequestRejected("batch execution failed: "
                                                "%s: %s" % (type(e).__name__,
                                                            e)))
                        failed += 1
                with self._stats_lock:
                    self.stats["errors"] += failed
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _stage(self, array):
        """Host -> device for one padded host batch."""
        return torch.from_numpy(array).to(self.device)

    @staticmethod
    def _fetch(outs, total):
        """The valid rows of every output and a per-row non-finite mask,
        on the host.  THE host sync of the serving path: the mask is
        computed on the device, then everything comes over in one go."""
        valid = [o[:total] for o in outs]
        bad = None
        for o in valid:
            if o.is_floating_point():
                row_bad = ~torch.isfinite(o.reshape(total, -1)).all(dim=1)
                bad = row_bad if bad is None else (bad | row_bad)
        host = [o.cpu().numpy() for o in valid]
        return host, (None if bad is None else bad.cpu().numpy())

    def _serve_batch(self, picked, total, bucket):
        t0 = time.perf_counter()
        inputs = {}
        for name, sshape in self._model.sample_shapes.items():
            buf = np.zeros((bucket,) + sshape, dtype=np.float32)
            off = 0
            for r in picked:
                buf[off:off + r.n] = r.inputs[name]
                off += r.n
            inputs[name] = self._stage(buf)  # rows past `total` are padding
        with torch.inference_mode():
            host_outs, bad_rows = self._fetch(self._model.run(inputs, bucket),
                                              total)
        t1 = time.perf_counter()
        off = 0
        completed = 0
        for r in picked:
            rows = slice(off, off + r.n)
            off += r.n
            if bad_rows is not None and bad_rows[rows].any():
                self._reject_nonfinite(r, bucket)
                continue
            r._complete([o[rows] for o in host_outs])
            completed += 1
        with self._stats_lock:
            s = self.stats
            s["completed"] += completed
            s["requests"] += len(picked)
            s["samples"] += total
            s["batches"] += 1
            s["padded_rows"] += bucket - total
            pb = s["per_bucket"][bucket]
            pb["batches"] += 1
            pb["samples"] += total
            s.setdefault("first_batch_t", t0)
            s["last_batch_t"] = t1

    def _reject_nonfinite(self, req, bucket):
        req._fail(RequestRejected(
            "served output contains non-finite values — response rejected "
            "(serving NaN sentinel)"))
        self._count_reject("rejected_nonfinite")
        _log.warning("non-finite values in a served output (bucket %d, %d "
                     "sample(s)) — response rejected, not returned",
                     bucket, req.n)

    # ----------------------------------------------------------- read side
    def queue_depth(self):
        """Currently queued samples (accepted, not yet batched)."""
        return self._queued_samples

    def snapshot(self):
        """Serving totals, rejections by kind, per-bucket use and the
        samples per second over the served window."""
        with self._stats_lock:
            s = dict(self.stats)
            per_bucket = {b: dict(v) for b, v in s["per_bucket"].items()}
        span = s.get("last_batch_t", 0.0) - s.get("first_batch_t", 0.0)
        return {"running": self._running, "device": str(self.device),
                "buckets": list(self.buckets),
                "requests": s["requests"], "samples": s["samples"],
                "batches": s["batches"], "padded_rows": s["padded_rows"],
                "completed": s["completed"], "errors": s["errors"],
                "rejected": {"queue": s["rejected_queue"],
                             "nonfinite": s["rejected_nonfinite"],
                             "shape": s["rejected_shape"]},
                "per_bucket": {str(b): v for b, v in per_bucket.items()
                               if v["batches"]},
                "samples_per_s": s["samples"] / span if span > 0 else None}
