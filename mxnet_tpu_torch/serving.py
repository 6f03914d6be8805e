"""Continuous-batching inference server of the PyTorch port.

Counterpart of ``mxnet_tpu/serving.py`` (``InferenceServer``), with its
surface: a thread-safe request queue in front of a loaded model (a
:class:`~mxnet_tpu_torch.predictor.Predictor`, a Gluon block or a
callable); a batcher thread that packs whole requests into bucketed
batch shapes (a ladder, default 1/2/4/8/16, zero-padded to the bucket,
the pad rows masked out of the scatter); ONE executable per bucket,
built lazily on first use (or by :meth:`InferenceServer.warmup`) and
counted (``stats["bucket_compiles"]``, ``serve_bucket_compiles``, the
build time in ``serve:bucket_build``); a small worker pool that stages
each batch onto the device, runs it and scatters the rows back.  A full
queue rejects at submit (explicit backpressure), :meth:`stop` drains
accepted requests, and a row with a NaN or infinity in any output is
rejected with :class:`RequestRejected` and a rate-limited warning, never
returned.  Every batch feeds the telemetry layers as the JAX server's
does: the ``serve:queue_wait``, ``serve:e2e``, ``serve:batch`` and
``serve:batch:b<B>`` histograms (the histogram layer is raised on
construction unless ``MXNET_TPU_HISTOGRAMS=0``), the ``serve_*``
counters of ``runtime_stats``, the request x-ray (``reqtrace``), the SLO
error budget (``slo``), and a per-batch JSONL timeline.  The knobs
:meth:`set_workers`, :meth:`set_max_wait_ms` and :meth:`set_max_queue`
act on a running server, each change kept in an audit trail.

A bucket's executable:

- a hybridized block on the card: its captured graph at the bucket's
  signature (``HybridBlock._cached_graph``), one CUDA graph, captured at
  the build;
- a ``Predictor``: a weight-sharing ``_reshape_clone`` a bucket, whose
  executor's predict forward is one captured CUDA graph on the card;
- a plain block, a block on the CPU, or a callable: eager, as in the JAX
  package.

What differs from the JAX package:

- A bucket executable with device state (a graph's static buffers, an
  executor's bound arrays) runs one batch at a time: a lock from the
  replay until its outputs' valid rows are cloned on the device, and a
  CUDA event that orders the next replay after those reads.  The next
  batch's replay may then run while this batch's rows travel to the
  host.  A hybridized block served through its graph does not fire its
  own forward hooks.
- Each worker thread stages, runs and copies its batches on a CUDA
  stream of its own, under ``torch.inference_mode()`` (grad mode is
  thread-local in PyTorch, so a mode set by the caller's thread would
  not reach the workers).
- The result copy: the non-finite row mask is computed on the device,
  then only the valid rows travel, in one asynchronous copy into
  page-locked host memory on the worker's stream, followed by a wait on
  an event (no device-wide sync).  The caller receives every row of every
  output as numpy arrays, views of that pinned memory; PyTorch's caching
  host allocator takes a block back once every view of it is gone.
  ``serve_bytes_out`` counts those valid rows (the JAX server's counts
  the bucket's rows, pad rows included).
- The timeline's ``live_bytes`` is ``torch.cuda.memory_allocated`` (the
  port has no device-memory tracker yet; None on the CPU).
- No autopilot reflexes, no health-layer flight record of a rejected
  row, no Prometheus export, ``tools/loadgen.py``, perfdoctor rules or
  ``diagnose --serving`` yet (ROADMAP Queue 1 item 9).
- ``device`` names where batches run: ``None`` means the Predictor's
  device, else ``gpu(0)``.

Environment variables (the JAX package's, as the constructor's defaults)
---------------------------------------------------------------------
``MXNET_TPU_SERVE_BUCKETS``   comma bucket ladder (default
    ``1,2,4,8,16``); the largest bucket is the max batch.
``MXNET_TPU_SERVE_QUEUE``     max queued samples before submissions are
    rejected (default 1024).
``MXNET_TPU_SERVE_WAIT_MS``   max milliseconds a partial batch waits for
    more requests while every worker is busy (default 2.0).
``MXNET_TPU_SERVE_WORKERS``   pipeline worker threads (default 2).
``MXNET_TPU_SERVE_METRICS``   JSONL path for per-batch timeline samples
    (rank-suffixed via ``log.rank_suffix_path``).
``MXNET_TPU_SERVE_SENTINEL``  ``0`` disables the non-finite sentinel.
``MXNET_TPU_SERVE_WARN_INTERVAL``  min seconds between non-finite
    rejection warnings (default 60).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

import numpy as np
import torch

from . import histogram as _histogram
from . import reqtrace as _reqtrace
from . import runtime_stats as _rts
from . import slo as _slo
from .context import resolve_device
from .log import get_logger, rank_suffix_path, warn_rate_limited

__all__ = ["InferenceServer", "RequestRejected", "ServerStopped",
           "DEFAULT_BUCKETS", "snapshot", "servers", "reset"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

WARN_INTERVAL = float(os.environ.get("MXNET_TPU_SERVE_WARN_INTERVAL", "60"))

_logger_cache: list = []


def _logger():
    if not _logger_cache:
        _logger_cache.append(get_logger("mxnet_tpu_torch.serving"))
    return _logger_cache[0]


class RequestRejected(RuntimeError):
    """The server refused (queue full, bad shape) or rejected (non-finite
    output, failed batch) this request."""


class ServerStopped(RuntimeError):
    """The server stopped without serving this request
    (``stop(drain=False)``)."""


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_buckets():
    raw = os.environ.get("MXNET_TPU_SERVE_BUCKETS")
    if not raw:
        return DEFAULT_BUCKETS
    try:
        out = tuple(sorted({int(b) for b in raw.split(",") if b.strip()}))
    except ValueError:
        return DEFAULT_BUCKETS
    return out or DEFAULT_BUCKETS


class _Request:
    """One queued request: named input arrays with a leading sample axis,
    and the future the caller waits on."""

    __slots__ = ("inputs", "n", "t_submit", "t_batched", "t_done",
                 "_event", "_outputs", "_error",
                 # request x-ray: set only while reqtrace is on
                 "rid", "trace")

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


class _Executable:
    """One bucket's executable: ``run(inputs, total)`` gives the first
    ``total`` rows of every output on the device, tensors no later run
    overwrites.  ``lock`` (None for a callable, whose runs may overlap)
    serializes the runs that share device state; on the card ``done`` is
    the event after the last run's reads, on the stream it ran on."""

    __slots__ = ("run", "lock", "done")

    def __init__(self, run, lock):
        self.run, self.lock, self.done = run, lock, None


def _rows(out, total):
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return [o[:total] for o in outs]


def _torch_dtype(dtype):
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class _PredictorModel:
    """Bucket executables over a loaded :class:`Predictor`: one
    weight-sharing ``_reshape_clone`` a bucket, whose executor's predict
    forward is captured at the build (on the card).  Its bound arrays
    are the graph's static inputs, so a bucket's runs are serialized."""

    def __init__(self, predictor):
        self._pred = predictor
        self.input_names = list(predictor.get_input_names())
        exec_args = predictor._exec.arg_dict
        self.sample_shapes = {n: tuple(exec_args[n].shape[1:])
                              for n in self.input_names}
        self.dtypes = {n: np.dtype(predictor._type_dict.get(n, np.float32))
                       for n in self.input_names}

    def build(self, bucket):
        shapes = {n: (bucket,) + self.sample_shapes[n]
                  for n in self.input_names}
        ex = self._pred._reshape_clone(shapes)._exec

        def run(inputs, total):
            outs = ex.forward(is_train=False, **inputs)
            return [o.data_torch[:total] for o in outs]

        with torch.inference_mode():
            run({n: torch.zeros(s, dtype=_torch_dtype(self.dtypes[n]),
                                device=ex._device)
                 for n, s in shapes.items()}, bucket)
        return _Executable(run, threading.Lock())


class _BlockModel:
    """Bucket executables over a Gluon block with one input.  A
    hybridized block on the card serves its captured graph at the
    bucket's signature, captured at the build, its outputs' valid rows
    cloned out of the graph's buffers; any other block runs eagerly,
    its calls serialized under one lock, as in the JAX package."""

    def __init__(self, block, sample_shape, input_name="data",
                 dtype=np.float32, device=None):
        self._block = block
        self._device = device
        self._lock = threading.Lock()
        self.input_names = [input_name]
        self.sample_shapes = {input_name: tuple(sample_shape)}
        self.dtypes = {input_name: np.dtype(dtype)}

    def build(self, bucket):
        from .gluon.block import HybridBlock

        block, name = self._block, self.input_names[0]
        if not (isinstance(block, HybridBlock) and block._active
                and self._device.type == "cuda"):
            def eager(inputs, total):
                return _rows(block(inputs[name]), total)

            return _Executable(eager, self._lock)
        x = torch.zeros((bucket,) + self.sample_shapes[name],
                        dtype=_torch_dtype(self.dtypes[name]),
                        device=self._device)
        with torch.inference_mode():
            graph, flat = block._cached_graph([x])
            graph.prepare(flat)

        def replay(inputs, total):
            outs = graph.replay_forward([inputs[name]], clone=False)
            return [o[:total].clone() for o in outs]

        return _Executable(replay, threading.Lock())


class _CallableModel:
    """Bucket executables over a callable ``fn(inputs, bucket) ->
    output(s)`` (tensors in, tensors out), eager, its runs not
    serialized."""

    def __init__(self, fn, input_shapes, dtypes=None):
        self._fn = fn
        self.input_names = list(input_shapes)
        self.sample_shapes = {n: tuple(s) for n, s in input_shapes.items()}
        self.dtypes = {n: np.dtype((dtypes or {}).get(n, np.float32))
                       for n in self.input_names}

    def build(self, bucket):
        fn = self._fn
        return _Executable(lambda inputs, total: _rows(fn(inputs, bucket),
                                                       total), None)


def _adapt(model, input_shapes, device):
    from .predictor import Predictor

    if isinstance(model, Predictor):
        return _PredictorModel(model)
    if not input_shapes:
        raise ValueError("the model needs input_shapes "
                         "({name: per-sample shape})")
    if not isinstance(model, torch.nn.Module):
        return _CallableModel(model, input_shapes)
    if len(input_shapes) != 1:
        raise ValueError("block serving supports exactly one input")
    (name, shape), = input_shapes.items()
    return _BlockModel(model, shape, input_name=name, device=device)


# --------------------------------------------------------------- server


# LIVE servers, newest last; a stopped server leaves the registry and its
# final snapshot in _FINAL
_SERVERS: list = []
_FINAL: list = []


class InferenceServer:
    """Continuous-batching inference server over a loaded model.

    Parameters
    ----------
    model : Predictor | gluon.Block | callable
        A ``Predictor`` brings its input names and shapes; a block takes
        one input; a callable is ``fn(inputs, bucket)``.
    input_shapes : dict
        ``{name: per-sample shape}`` (no batch axis), for a block or a
        callable.  Requests arrive as float32 (a language model's token
        ids are exact below 2**24).
    buckets : tuple of int, optional
        Batch-size ladder (default ``MXNET_TPU_SERVE_BUCKETS`` or
        1/2/4/8/16); the largest bucket caps a request's samples.
    max_wait_ms / max_queue / workers : optional
        Batch-formation wait while every worker is busy, bound on queued
        samples, pipeline worker threads; each defaults from its
        ``MXNET_TPU_SERVE_*`` row.
    metrics_path : str, optional
        JSONL destination for per-batch samples (default
        ``MXNET_TPU_SERVE_METRICS``).
    device
        Where batches run; ``None`` means the Predictor's device, else
        ``gpu(0)``.  The model must live on this device.
    """

    def __init__(self, model, input_shapes=None, buckets=None,
                 max_wait_ms=None, max_queue=None, workers=None,
                 metrics_path=None, name="serve", device=None):
        from .predictor import Predictor

        if device is None and isinstance(model, Predictor):
            device = model._ctx
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        home = None
        if isinstance(model, Predictor):
            home = model._ctx
        elif isinstance(model, torch.nn.Module):
            p = next(model.parameters(), None)
            home = None if p is None else p.device
        if home is not None and home != self.device:
            raise ValueError("the model lives on %s, the server on %s"
                             % (home, self.device))
        self._model = _adapt(model, input_shapes, self.device)
        self.buckets = tuple(sorted(set(buckets or _env_buckets())))
        if not self.buckets or any(b <= 0 for b in self.buckets):
            raise ValueError("buckets must be positive ints")
        self.max_bucket = self.buckets[-1]
        self.max_wait = (_env_float("MXNET_TPU_SERVE_WAIT_MS", 2.0)
                         if max_wait_ms is None else float(max_wait_ms)) / 1e3
        self.max_queue = _env_int("MXNET_TPU_SERVE_QUEUE", 1024) \
            if max_queue is None else int(max_queue)
        self.num_workers = max(1, _env_int("MXNET_TPU_SERVE_WORKERS", 2)
                               if workers is None else int(workers))
        self.name = name
        self._sentinel_on = os.environ.get("MXNET_TPU_SERVE_SENTINEL") != "0"
        self._metrics_path = metrics_path if metrics_path is not None \
            else os.environ.get("MXNET_TPU_SERVE_METRICS")
        self._metrics_file = None
        self._metrics_lock = threading.Lock()

        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._queued_samples = 0    # under _cond
        self._inflight = 0          # under _cond
        self._stopping = False      # set under _cond, re-checked under it
        self._running = False
        self._threads: list = []
        self._batchq: collections.deque = collections.deque()
        self._batch_cond = threading.Condition()
        # double-checked build cache: a lock-free get, builds serialized
        # under _bucket_lock (captures share one side stream)
        self._bucket_fns: dict = {}
        self._bucket_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "samples": 0, "batches": 0,
                      "padded_rows": 0, "rejected_queue": 0,
                      "rejected_nonfinite": 0, "rejected_shape": 0,
                      "completed": 0, "errors": 0,
                      "bucket_compiles": 0, "knob_adjusts": 0,
                      "per_bucket": {b: {"batches": 0, "samples": 0}
                                     for b in self.buckets},
                      "first_batch_t": None, "last_batch_t": None}
        self._rejections: collections.deque = collections.deque(maxlen=64)
        # knob audit trail, under _stats_lock
        self._adjustments: collections.deque = collections.deque(maxlen=32)
        # live workers, under _batch_cond: grown by set_workers, shrunk by
        # idle workers retiring while it exceeds num_workers
        self._worker_count = 0
        self._batch_seq = 0
        # latency percentiles are the product: raise the histogram layer
        # unless the environment forces it off
        if os.environ.get("MXNET_TPU_HISTOGRAMS") != "0":
            _histogram.enable()
        _SERVERS.append(self)

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
        with self._batch_cond:
            self._worker_count = self.num_workers
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
            if self in _SERVERS:
                _SERVERS.remove(self)
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
        self._close_metrics()
        _FINAL[:] = [self.snapshot()]
        if self in _SERVERS:
            _SERVERS.remove(self)

    def warmup(self):
        """Build every bucket's executable (on the card, capture its
        graph) and run one all-zeros batch through it, so the first real
        request pays no build and the pinned host memory of each bucket's
        results is allocated."""
        with self._on_stream(self._new_stream()), torch.inference_mode():
            for b in self.buckets:
                exe = self._bucket_fn(b)
                inputs = {n: self._stage(np.zeros((b,) + s,
                                                  self._model.dtypes[n]))
                          for n, s in self._model.sample_shapes.items()}
                self._fetch(self._execute(exe, inputs, b), b)
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
                self._count_reject("rejected_queue", n)
                raise RequestRejected(
                    "queue full (%d queued samples, max %d) — backpressure;"
                    " retry or add capacity" % (self._queued_samples,
                                               self.max_queue))
            depth = self._queued_samples
            self._queue.append(req)
            self._queued_samples += n
            # the lifecycle record opens under _cond, so the batcher never
            # sees a traced request before its record exists
            if _reqtrace._state["on"]:
                _reqtrace.on_submit(req, depth)
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
            arr = np.asarray(arr, dtype=self._model.dtypes[name], order="C")
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

    def _count_reject(self, kind, n=0):
        with self._stats_lock:
            self.stats[kind] += 1
        _rts.inc("serve_rejected")
        _rts.inc("serve_" + kind)
        # a front-door reject never enters the pipeline: an explicit
        # lifecycle outcome and an SLO bad event here; a non-finite
        # rejection reaches both through _reject_nonfinite
        if kind != "rejected_nonfinite":
            if _reqtrace._state["on"]:
                _reqtrace.on_reject(kind, n)
            if _slo._state["on"]:
                _slo.on_request(None, False)

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
            if _reqtrace._state["on"]:
                _reqtrace.on_join(picked, bucket)
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

    def _bucket_fn(self, bucket):
        exe = self._bucket_fns.get(bucket)
        if exe is not None:
            return exe
        with self._bucket_lock:
            exe = self._bucket_fns.get(bucket)
            if exe is None:
                t0 = time.perf_counter()
                exe = self._bucket_fns[bucket] = self._model.build(bucket)
                with self._stats_lock:
                    self.stats["bucket_compiles"] += 1
                _rts.inc("serve_bucket_compiles")
                if _histogram._state["on"]:
                    _histogram.observe("serve:bucket_build",
                                       time.perf_counter() - t0)
        return exe

    # ------------------------------------------------------------- workers
    def _new_stream(self):
        return torch.cuda.Stream(self.device) if self._cuda else None

    @staticmethod
    def _on_stream(stream):
        return contextlib.nullcontext() if stream is None \
            else torch.cuda.stream(stream)

    def _worker_loop(self):
        stream = self._new_stream()
        while True:
            with self._batch_cond:
                while not self._batchq:
                    if self._worker_count > self.num_workers:
                        # shrunk by set_workers: a surplus worker retires
                        # when idle, never mid-batch
                        self._worker_count -= 1
                        return
                    if self._stopping and self._batcher_done():
                        return
                    self._batch_cond.wait(timeout=0.1)
                picked, total, bucket = self._batchq.popleft()
                self._batch_cond.notify_all()
            try:
                self._serve_batch(picked, total, bucket, stream)
            except Exception as e:  # a bad batch must not kill the pool
                self._fail_batch(picked, e)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _batcher_done(self):
        return self._threads and not self._threads[0].is_alive()

    def _fail_batch(self, picked, e):
        failed = 0
        for r in picked:
            if not r.done():
                r._fail(RequestRejected("batch execution failed: %s: %s"
                                        % (type(e).__name__, e)))
                failed += 1
                if _reqtrace._state["on"]:
                    _reqtrace.on_done(r, "error", r.t_done)
                if _slo._state["on"]:
                    _slo.on_request((r.t_done - r.t_submit) * 1e3, False)
        if failed:
            with self._stats_lock:
                self.stats["errors"] += failed
        warn_rate_limited(
            _logger(), "serving:batch-error", WARN_INTERVAL,
            "serving batch failed (%s: %s) — %d request(s) rejected",
            type(e).__name__, e, len(picked))

    def _stage(self, array):
        """Host -> device for one padded host batch, on the current
        stream."""
        return torch.from_numpy(array).to(self.device)

    def _execute(self, exe, inputs, total):
        """``exe``'s valid output rows for ``inputs``, on the current
        stream: after the last run's reads (its event), one run at a time
        where the executable holds device state."""
        if exe.lock is None:
            return exe.run(inputs, total)
        with exe.lock:
            if exe.done is not None:
                torch.cuda.current_stream(self.device).wait_event(exe.done)
            outs = exe.run(inputs, total)
            if self._cuda:
                exe.done = torch.cuda.Event()
                exe.done.record()
        return outs

    def _fetch(self, outs, total):
        """Every output's valid rows and the per-row non-finite mask (None
        with the sentinel off), as numpy.  THE host sync of the serving
        path: on the card the mask is computed on the device, then all of
        it is copied asynchronously into pinned host memory on the current
        stream, and the host waits on one event."""
        bad = self._sentinel(outs, total)
        # numpy has no bf16: a bf16 output is handed back as float32, as
        # the port's asnumpy() does
        outs = [o.float() if o.dtype == torch.bfloat16 else o for o in outs]
        if not self._cuda:
            return [o.numpy() for o in outs], \
                None if bad is None else bad.numpy()
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        if bad is not None:
            bad_host = torch.empty(bad.shape, dtype=bad.dtype,
                                   pin_memory=True)
            bad_host.copy_(bad, non_blocking=True)
            bad = bad_host
        copied = torch.cuda.Event()
        copied.record()
        copied.synchronize()
        return [h.numpy() for h in host], \
            None if bad is None else bad.numpy()

    def _sentinel(self, outs, total):
        """The rows (of ``total``) with a NaN or infinity in any float
        output, as a device bool tensor, or None when disabled or no
        output is float."""
        if not self._sentinel_on:
            return None
        bad = None
        for o in outs:
            if o.is_floating_point():
                row_bad = ~torch.isfinite(o.reshape(total, -1)).all(dim=1)
                bad = row_bad if bad is None else (bad | row_bad)
        return bad

    def _serve_batch(self, picked, total, bucket, stream):
        t0 = time.perf_counter()
        hist_on = _histogram._state["on"]
        rt_on = _reqtrace._state["on"]
        slo_on = _slo._state["on"]
        if hist_on:
            for r in picked:
                _histogram.observe("serve:queue_wait",
                                   r.t_batched - r.t_submit)
        bufs = {}
        bytes_in = 0
        for name, sshape in self._model.sample_shapes.items():
            buf = np.empty((bucket,) + sshape, dtype=self._model.dtypes[name])
            off = 0
            for r in picked:
                buf[off:off + r.n] = r.inputs[name]
                off += r.n
            buf[off:] = 0  # the pad rows, masked out of the scatter
            bytes_in += buf.nbytes
            bufs[name] = buf
        with self._on_stream(stream), torch.inference_mode():
            inputs = {n: self._stage(b) for n, b in bufs.items()}
            t_staged = time.perf_counter() if rt_on else None
            exe = self._bucket_fn(bucket)
            host_outs, bad_rows = self._fetch(
                self._execute(exe, inputs, total), total)
        t1 = time.perf_counter()
        if rt_on:
            _reqtrace.on_exec(picked, threading.current_thread().name,
                              bucket - total, t_staged, t1)
        bytes_out = sum(int(o.nbytes) for o in host_outs)
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
            if rt_on:
                _reqtrace.on_done(r, "ok", r.t_done)
            if slo_on:
                _slo.on_request((r.t_done - r.t_submit) * 1e3, True)
        if completed:
            with self._stats_lock:
                self.stats["completed"] += completed
        if hist_on:
            _histogram.observe("serve:batch", t1 - t0)
            _histogram.observe("serve:batch:b%d" % bucket, t1 - t0)
            for r in picked:
                _histogram.observe("serve:e2e", r.t_done - r.t_submit)
        self._account_batch(picked, total, bucket, t0, t1, bytes_in,
                            bytes_out)

    def _reject_nonfinite(self, req, bucket):
        req._fail(RequestRejected(
            "served output contains non-finite values — response rejected "
            "(serving NaN sentinel)"))
        self._count_reject("rejected_nonfinite")
        self._rejections.append({"t": time.time(), "bucket": bucket,
                                 "n": req.n, "reason": "non-finite output"})
        warn_rate_limited(
            _logger(), "serving:nonfinite", WARN_INTERVAL,
            "non-finite values in a served output (bucket %d, %d sample(s))"
            " — response rejected, not returned", bucket, req.n)
        if _reqtrace._state["on"]:
            _reqtrace.on_done(req, "rejected_nonfinite", req.t_done)
        if _slo._state["on"]:
            _slo.on_request((req.t_done - req.t_submit) * 1e3, False)

    def _account_batch(self, picked, total, bucket, t0, t1, bytes_in,
                       bytes_out):
        wall = t1 - t0
        with self._stats_lock:
            s = self.stats
            s["requests"] += len(picked)
            s["samples"] += total
            s["batches"] += 1
            s["padded_rows"] += bucket - total
            pb = s["per_bucket"][bucket]
            pb["batches"] += 1
            pb["samples"] += total
            if s["first_batch_t"] is None:
                s["first_batch_t"] = t0
            s["last_batch_t"] = t1
            self._batch_seq += 1
            seq = self._batch_seq
        _rts.inc("serve_requests", len(picked))
        _rts.inc("serve_samples", total)
        _rts.inc("serve_batches")
        _rts.inc("serve_padded_rows", bucket - total)
        _rts.inc("serve_bytes_in", bytes_in)
        _rts.inc("serve_bytes_out", bytes_out)
        if self._metrics_path:
            waits = [r.t_batched - r.t_submit for r in picked]
            e2es = [r.t_done - r.t_submit for r in picked
                    if r.t_done is not None]
            self._write_metrics({
                "t": time.time(), "step": seq, "wall_ms": wall * 1e3,
                "throughput": (total / wall) if wall > 0 else None,
                "bucket": bucket, "n": total,
                "occupancy": total / bucket,
                "queue_wait_ms": sum(waits) / len(waits) * 1e3
                if waits else 0.0,
                "e2e_ms": sum(e2es) / len(e2es) * 1e3 if e2es else None,
                "queue_depth": self._queued_samples,
                "live_bytes": torch.cuda.memory_allocated(self.device)
                if self._cuda else None})

    # ------------------------------------------------------- JSONL export
    def _write_metrics(self, sample):
        """One whole line a batch, to the rank-suffixed path; the export
        goes dark with one warning on an IO failure."""
        with self._metrics_lock:
            f = self._metrics_file
            if f is None:
                path = rank_suffix_path(self._metrics_path)
                try:
                    f = open(path, "a", buffering=1)
                except OSError as e:
                    warn_rate_limited(
                        _logger(), "serving:metrics-open", 60,
                        "cannot open MXNET_TPU_SERVE_METRICS file %s (%s) — "
                        "serving timeline export disabled", path, e)
                    self._metrics_path = None
                    return
                self._metrics_file = f
            try:
                f.write(json.dumps(sample, separators=(",", ":"),
                                   default=repr) + "\n")
            except (OSError, ValueError) as e:
                warn_rate_limited(
                    _logger(), "serving:metrics-write", 60,
                    "writing a serving timeline sample failed (%s) — "
                    "export disabled", e)
                self._metrics_path = None
                self._close_metrics_locked()

    def _close_metrics(self):
        with self._metrics_lock:
            self._close_metrics_locked()

    def _close_metrics_locked(self):
        f = self._metrics_file
        self._metrics_file = None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    # -------------------------------------------------------- runtime knobs
    def _note_adjust(self, knob, old, new):
        rec = {"t": time.time(), "knob": knob, "old": old, "new": new}
        with self._stats_lock:
            self.stats["knob_adjusts"] += 1
            self._adjustments.append(rec)
        _rts.inc("serve_knob_adjusts")

    def set_workers(self, n):
        """Set the worker count of a running server: growing starts
        workers at once; shrinking lets surplus workers retire at their
        next idle wait (never mid-batch).  The batcher reads
        ``num_workers`` afresh every batch."""
        n = max(1, int(n))
        # both conditions guard reads of num_workers; no other path holds
        # the two at once, so the nesting cannot deadlock
        with self._cond, self._batch_cond:
            old = self.num_workers
            self.num_workers = n
            spawn = 0
            if self._running and not self._stopping:
                spawn = max(0, n - self._worker_count)
                self._worker_count += spawn
            self._batch_cond.notify_all()
            self._cond.notify_all()
        for _ in range(spawn):
            w = threading.Thread(
                target=self._worker_loop,
                name="mxt-serve-worker-%d" % len(self._threads), daemon=True)
            w.start()
            self._threads.append(w)
        if n != old:
            self._note_adjust("workers", old, n)
        return n

    def set_max_wait_ms(self, ms):
        """Set the batch-formation wait (read afresh every batch)."""
        ms = max(0.0, float(ms))
        with self._cond:
            old = self.max_wait * 1e3
            self.max_wait = ms / 1e3
            self._cond.notify_all()
        if ms != old:
            self._note_adjust("max_wait_ms", round(old, 3), round(ms, 3))
        return ms

    def set_max_queue(self, n):
        """Set the queued-sample bound (read afresh at every submit)."""
        n = max(1, int(n))
        old = self.max_queue
        self.max_queue = n
        if n != old:
            self._note_adjust("max_queue", old, n)
        return n

    # ----------------------------------------------------------- read side
    def queue_depth(self):
        """Currently queued samples (accepted, not yet batched)."""
        return self._queued_samples

    def snapshot(self):
        """JSON-ready serving stats: totals, rejections by kind, outcomes,
        per-bucket use, bucket builds, samples per second over the served
        window (``qps``), the knob audit trail and the recent rejection
        records.  Latencies are in the ``serve:*`` histograms."""
        with self._stats_lock:
            s = dict(self.stats)
            per_bucket = {b: dict(v)
                          for b, v in self.stats["per_bucket"].items()}
            adjustments = list(self._adjustments)[-8:]
        rejections = list(self._rejections)[-16:]
        qps = None
        if s["first_batch_t"] is not None and s["samples"]:
            span = (s["last_batch_t"] or 0) - s["first_batch_t"]
            if span > 0:
                qps = s["samples"] / span
        total_rows = sum(b * v["batches"] for b, v in per_bucket.items())
        return {"enabled": True, "running": self._running,
                "name": self.name, "device": str(self.device),
                "buckets": list(self.buckets),
                "workers": self.num_workers, "max_queue": self.max_queue,
                "max_wait_ms": self.max_wait * 1e3,
                "queue_depth": self._queued_samples,
                "requests": s["requests"], "samples": s["samples"],
                "batches": s["batches"], "padded_rows": s["padded_rows"],
                "completed": s["completed"], "errors": s["errors"],
                "bucket_compiles": s["bucket_compiles"],
                "rejected": {"queue": s["rejected_queue"],
                             "nonfinite": s["rejected_nonfinite"],
                             "shape": s["rejected_shape"]},
                "outcomes": {"ok": s["completed"],
                             "rejected_queue": s["rejected_queue"],
                             "rejected_shape": s["rejected_shape"],
                             "rejected_nonfinite": s["rejected_nonfinite"],
                             "error": s["errors"]},
                "per_bucket": {str(b): v for b, v in per_bucket.items()
                               if v["batches"]},
                "qps": qps, "knob_adjusts": s["knob_adjusts"],
                "adjustments": adjustments, "rejections": rejections,
                "mean_occupancy": s["samples"] / total_rows
                if total_rows else None}


# ------------------------------------------------------- module surface


def servers():
    """Every live (not yet stopped) server, oldest first."""
    return list(_SERVERS)


def snapshot():
    """The newest live server's snapshot, the last stopped server's final
    one when none is live, or ``{"enabled": False}``; what
    ``runtime_stats.snapshot()["serving"]`` embeds."""
    if _SERVERS:
        return _SERVERS[-1].snapshot()
    if _FINAL:
        return dict(_FINAL[0])
    return {"enabled": False}


def reset():
    """Forget every live server and the retained final snapshot
    (tests)."""
    from .log import reset_rate_limits

    _SERVERS.clear()
    _FINAL.clear()
    reset_rate_limits("serving:")
