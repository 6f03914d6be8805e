"""Checkpoints of the PyTorch port: atomic writes, an asynchronous
checkpoint manager with checksummed manifests, one-call auto-resume and
the legacy prefix/epoch files.

Counterpart of ``mxnet_tpu/checkpoint.py``, with its layout, names and
environment variables, so a checkpoint crosses between the packages in
both directions:

- :func:`atomic_write`: a temporary file in the target's directory,
  fsync, ``os.replace``, fsync of the directory; every persistence path
  of the port writes through it (``Block.save_parameters``,
  ``Trainer.save_states``, ``Module.save_optimizer_states``,
  ``model.save_checkpoint``, the manager's files).
- :class:`CheckpointManager`: ``<directory>/ckpt-%08d/`` holding
  ``params.npz`` (the parameters by name), ``trainer.pkl`` (the updater
  states and the optimizer's hyper-state), ``aux.pkl`` (an opaque payload,
  when given) and ``MANIFEST.json`` with every file's SHA-256.  A
  checkpoint exists when its manifest is valid and every checksum
  matches; :meth:`CheckpointManager.latest` quarantines a torn or corrupt
  one and falls back to the newest valid one.  Keep-last-N retention,
  stale staging directories pruned, a same-step overwrite through a
  ``.retire-`` name.
- ``trainer.pkl`` names the JAX package's classes
  (``mxnet_tpu.checkpoint._NDLeaf``, ``mxnet_tpu.optimizer.optimizer.<Opt>``)
  and holds numpy arrays and plain Python values only, written by a
  pickler that names those classes without importing them
  (:class:`_JaxPickler`); the port reads it, and the JAX package's own
  ``trainer.pkl``, through :func:`~mxnet_tpu_torch.optimizer.optimizer.
  read_states`, which imports nothing of the JAX package.  bf16 arrays,
  which numpy lacks, are stored widened to float32 (exact) and come back
  in their weight's type.

**The capture copies.**  The JAX package's snapshot takes references to
immutable XLA buffers (``mxnet_tpu/checkpoint.py:22-31``).  Here every
optimizer updates in place and a captured step rewrites the same
storages at each replay, so a snapshot is a copy, queued on the training
stream after the step's kernels and before the next step's: one
``torch._foreach_copy_`` of every parameter and state tensor into a
device staging slot (device to device), and a CUDA event.  The writer
thread waits on that event on a side stream, brings the slot to the host
in one copy into pinned staging, frees the slot, and writes the files;
the training thread never waits on the writer.  The manager allocates its
staging once (two device slots at the first capture, and the pinned
buffer at the writer's first copy; again only when the set of tensors
changes) and reuses it: one slot may be in
the writer's hands while the other holds the pending snapshot, and a new
capture while one is pending takes that pending slot back (the older
snapshot is dropped: back-to-back saves coalesce to the newest, counted
in ``totals['coalesced']``), so a capture never writes into the slot the
writer reads.  On the CPU the slots are host tensors and the writer reads
them directly.

Disabled (the default), the hook in ``Trainer.step`` and
``CompiledStep.step`` costs one dict read.  Environment variables, the
JAX package's: ``MXNET_TPU_CKPT`` (a directory: enable the global manager
at import), ``MXNET_TPU_CKPT_INTERVAL`` (save every N steps, default 100),
``MXNET_TPU_CKPT_KEEP`` (keep-last-N, default 5), ``MXNET_TPU_CKPT_ASYNC``
(``0``: write on the calling thread).

Not ported: :meth:`CheckpointManager.save_sharded` and
``auto_resume(zero_step=)`` raise until multi-GPU training is ported
(ROADMAP Queue 1 item 9); the manifest's probe holds the port's counters
(:func:`~mxnet_tpu_torch.runtime_stats.health_probe`) and no health
monitor, and no stepstats window times the capture (item 10).

``trainer.pkl`` and ``aux.pkl`` are plain pickle: load checkpoints only
from directories you trust, as with ``Trainer.load_states``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import itertools
import json
import os
import pickle
import re
import shutil
import struct
import threading
import time

import numpy as np
import torch

from . import histogram as _histogram
from . import runtime_stats as _rts
from .base import MXNetError
from .log import get_logger, warn_rate_limited

__all__ = ["atomic_write", "CheckpointManager", "enable", "disable",
           "is_enabled", "manager", "on_step", "auto_resume", "lineage",
           "snapshot", "reset", "save_legacy", "load_legacy", "load_aux",
           "MANIFEST_NAME", "MANIFEST_VERSION", "TRAINER_STATES_MAGIC",
           "TRAINER_STATES_VERSION"]

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1

# Trainer.save_states header: magic, one version byte, a newline, then
# the pickled states; a legacy headerless pickle still loads
TRAINER_STATES_MAGIC = b"MXTPUTRAINER"
TRAINER_STATES_VERSION = 1

# the JAX package's names, written into trainer.pkl
_JAX_LEAF = ("mxnet_tpu.checkpoint", "_NDLeaf")
_JAX_OPTIMIZERS = "mxnet_tpu.optimizer.optimizer"

_state = {"on": False}
_GLOBAL: list = []              # [CheckpointManager] while enabled
_tmp_seq = itertools.count(1)


def _logger():
    return get_logger("mxnet_tpu_torch.checkpoint")


# ------------------------------------------------------------ atomic IO


@contextlib.contextmanager
def atomic_write(path):
    """Yield a temporary path in ``path``'s directory; on a clean exit
    fsync it, rename it onto ``path`` and fsync the directory, so the
    final name only ever holds a whole file.  On an error the temporary
    file is removed and ``path`` is left as it was."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    tmp = os.path.join(d, ".%s.%d.%d.tmp" % (os.path.basename(path),
                                             os.getpid(), next(_tmp_seq)))
    try:
        yield tmp
        _fsync(tmp)
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _fsync(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    # makes a rename durable; some filesystems refuse it
    with contextlib.suppress(OSError):
        _fsync(path)


def _sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for b in iter(lambda: f.read(chunk), b""):
            h.update(b)
    return h.hexdigest()


def _write_file(path, write):
    """``write(f)`` into a new file at ``path``, fsynced; its manifest
    entry."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    return {"sha256": _sha256(path), "bytes": os.path.getsize(path)}


# ------------------------------------------------- trainer.pkl's classes


class _NDLeaf:
    """An array leaf of a state tree, pickled as the JAX package's
    ``mxnet_tpu.checkpoint._NDLeaf``: its numpy value once written (a
    staging view while the snapshot waits for the writer)."""

    __slots__ = ("value",)
    _pickle_as = _JAX_LEAF

    def __init__(self, value):
        self.value = value

    def __reduce__(self):
        return (_NDLeaf, (self.value,))


class _JaxObject:
    """An object pickled under a JAX package class (``_pickle_as``)."""


class _JaxPickler(pickle._Pickler):
    """The pure-Python pickler, writing a class that carries
    ``_pickle_as = (module, name)`` as that global, so the JAX package's
    ``pickle.load`` makes its own class of it; nothing is imported.  A
    large array's bytes go to the file straight from its buffer, as the
    C pickler writes them (the pure-Python one copies them first, holding
    the GIL: the training thread stalled behind the writer)."""

    def save_picklebuffer(self, obj):
        with obj.raw() as m:
            if m.nbytes < self.framer._FRAME_SIZE_TARGET:
                return super().save_picklebuffer(obj)
            op = pickle.BYTES8 if m.readonly else pickle.BYTEARRAY8
            self._write_large_bytes(op + struct.pack("<Q", m.nbytes), m)
        return None

    def save_global(self, obj, name=None):
        target = obj.__dict__.get("_pickle_as") \
            if isinstance(obj, type) else None
        if target is None:
            return super().save_global(obj, name)
        self.write(pickle.GLOBAL + ("%s\n%s\n" % target).encode("utf-8"))
        self.memoize(obj)
        return None


def _jax_dump(obj, f):
    _JaxPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)


def _jax_dumps(obj):
    buf = io.BytesIO()
    _jax_dump(obj, buf)
    return buf.getvalue()


def _optimizer_blob(optimizer):
    """The optimizer's hyper-state pickled as the JAX package's optimizer
    class of the same name: no ``param_dict`` (the per-parameter
    multipliers folded into ``lr_mult``/``wd_mult`` by index, as the JAX
    package's ``_strip_optimizer`` does) and no scheduler."""
    wire = dict(optimizer.__getstate__())
    wire["param_dict"] = {}
    wire["lr_mult"] = dict(optimizer.lr_mult)
    wire["wd_mult"] = dict(optimizer.wd_mult)
    for idx, p in getattr(optimizer, "param_dict", {}).items():
        for attr in ("lr_mult", "wd_mult"):
            if getattr(p, attr, 1.0) != 1.0:
                wire[attr][idx] = getattr(p, attr)
    name = type(optimizer).__name__
    stand_in = type(name, (_JaxObject,),
                    {"_pickle_as": (_JAX_OPTIMIZERS, name)})
    obj = stand_in.__new__(stand_in)
    obj.__dict__.update(wire)
    return _jax_dumps(obj)


def _hyper_state(blob):
    """The hyper-state dict of a pickled optimizer blob of either
    package, read without importing the JAX package."""
    from .optimizer.optimizer import Optimizer, _Stub, read_states

    src = read_states(blob)
    if isinstance(src, _Stub):
        return dict(getattr(src, "state", None) or {})
    if isinstance(src, Optimizer):
        return dict(src.__dict__)
    raise MXNetError("trainer.pkl's optimizer is a %s, not an optimizer"
                     % type(src).__name__)


# ----------------------------------------------------------- the capture


def _tree_map(obj, fn):
    """``obj`` rebuilt with every tensor replaced by ``fn(tensor)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _tree_map(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(v, fn) for v in obj)
    return obj


def _tree_leaves(obj, out):
    if isinstance(obj, _NDLeaf):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tree_leaves(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tree_leaves(v, out)
    return out


class _Slot:
    """One staging slot: a flat buffer and a view of it for each tensor,
    and the event its capture recorded (CUDA)."""

    def __init__(self, flat, views):
        self.flat = flat
        self.views = views
        self.event = None


class _Staging:
    """The staging of one set of tensors (shapes, dtypes, device): two
    slots on the tensors' device and, for a card, one pinned host buffer
    the writer copies a slot into."""

    ALIGN = 256

    def __init__(self, layout, device):
        self.layout = layout
        self.device = device
        offsets, total = [], 0
        for shape, dtype in layout:
            offsets.append(total)
            n = int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
            total += -(-n // self.ALIGN) * self.ALIGN
        self.total = total

        def views(flat):
            out = []
            for (shape, dtype), off in zip(layout, offsets):
                size = torch.empty((), dtype=dtype).element_size()
                n = int(np.prod(shape, dtype=np.int64)) * size
                out.append(flat[off:off + n].view(dtype).view(shape))
            return out

        self._views = views
        self.slots = []
        for _ in range(2):
            flat = torch.empty(max(total, 1), dtype=torch.uint8,
                               device=device)
            self.slots.append(_Slot(flat, views(flat)))
        self.host = None
        self.pinned = device.type == "cuda"
        if self.pinned:
            self.stream = torch.cuda.Stream(device)

    def host_slot(self):
        """The pinned buffer, made at the writer's first use (so its
        ``cudaHostAlloc`` never runs on the training thread)."""
        if self.host is None:
            flat = torch.empty(max(self.total, 1), dtype=torch.uint8,
                               pin_memory=True)
            self.host = _Slot(flat, self._views(flat))
        return self.host

    @property
    def nbytes(self):
        return self.total * (3 if self.pinned else 2)


def _numpy(t):
    """A host tensor as numpy (no copy), bf16 widened to float32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ------------------------------------------------------------- manager


class CheckpointManager:
    """Atomic, asynchronous, self-validating checkpoint store (module
    docstring): ``<directory>/<prefix>-<step:08d>/`` with ``params.npz``,
    ``trainer.pkl``, ``aux.pkl`` and ``MANIFEST.json``, staged in a
    temporary directory and renamed into place once every file is
    fsynced.

    ``totals``: ``saves`` (captures), ``written`` (commits),
    ``coalesced`` (pending snapshots a newer capture replaced),
    ``corrupt_skipped``, ``errors``, ``staging_allocs`` (how many times
    staging was allocated) and ``staging_bytes`` (its size: two slots and
    the pinned buffer)."""

    def __init__(self, directory, keep=5, interval=None, async_write=None,
                 prefix="ckpt"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, int(keep))
        self.interval = int(interval) if interval else 0
        if async_write is None:
            async_write = os.environ.get("MXNET_TPU_CKPT_ASYNC", "1") != "0"
        self.async_write = bool(async_write)
        self.prefix = prefix
        self._final_re = re.compile(r"^%s-(\d{8,})$" % re.escape(prefix))
        self.step_clock = 0
        self.last_good = None       # {"path", "step"} of the newest commit
        self.last_error = None
        # monitoring counters, each with one writer (the training thread:
        # saves, coalesced, staging; the writer: written, errors)
        self.totals = {"saves": 0, "written": 0, "coalesced": 0,
                       "corrupt_skipped": 0, "errors": 0,
                       "staging_allocs": 0, "staging_bytes": 0}
        self._cv = threading.Condition()
        self._queued = None         # the pending snapshot
        self._writing = False
        self._busy = None           # the slot the writer reads
        self._stop = False
        self._thread = None
        self._staging = None
        self._prune_stale_tmp()

    # ------------------------------------------------------------ save
    def save_trainer(self, trainer, step=None, extra=None, pin=False):
        """Snapshot a ``gluon.Trainer``'s resumable unit: its parameters
        by name, its updater's states, the optimizer's hyper-state, the
        random state and the step.  The tensors are copied on the current
        stream (module docstring); the call returns without waiting in
        async mode.  ``pin`` is the JAX package's flag for its compiled
        step's donated buffers; every capture here copies, so it changes
        nothing."""
        del pin
        step = self.step_clock if step is None else int(step)
        from .gluon.block import is_deferred

        params = {}
        for i, p in enumerate(trainer._params):
            if not is_deferred(p):
                params[_param_name(p, i)] = p.detach()
        updater = trainer._updaters[0] if trainer._updaters else None
        trainer_state = {}
        if updater is not None:
            trainer_state["states"] = _tree_map(
                dict(updater.states), lambda t: t.detach())
            trainer_state["optimizer"] = _optimizer_blob(trainer._optimizer)
        return self._capture(step, params, trainer_state, extra, None)

    def save(self, step, params, extra=None, aux=None):
        """Snapshot a plain ``{name: array}`` mapping (NDArrays, tensors
        or numpy arrays), no trainer; ``aux`` is an opaque picklable
        payload committed beside it (``aux.pkl``, checksummed), read back
        by :func:`load_aux`."""
        caps = {k: _as_tensor(v) for k, v in params.items()}
        return self._capture(int(step), caps, {}, extra, aux)

    def save_sharded(self, step, shard_files, aux=None):
        """ZeRO's per-rank checkpoint: not ported (one device)."""
        raise MXNetError("CheckpointManager.save_sharded writes ZeRO's "
                         "per-rank shards, which need more than one device; "
                         "multi-GPU training is not yet ported (ROADMAP "
                         "Queue 1 item 9)")

    def _capture(self, step, params, trainer_state, extra, aux):
        """Copy every tensor of the snapshot into a free staging slot on
        the current stream, and queue (or, in sync mode, write) it."""
        from . import random as _random

        tensors = list(params.values())

        def leaf(t):
            tensors.append(t)
            return _NDLeaf(len(tensors) - 1)

        states = _tree_map(trainer_state.get("states"), leaf)
        snap = {"step": step, "params": {k: _NDLeaf(i) for i, k in
                                         enumerate(params)},
                "trainer": dict(trainer_state, states=states)
                if trainer_state else {},
                "rng": _random.get_state(), "extra": extra, "aux": aux,
                "probe": self._probe(), "time": time.time()}
        devices = {t.device for t in tensors}
        if len(devices) > 1:
            raise MXNetError("checkpoint: the tensors lie on %s, not on one "
                             "device" % sorted(map(str, devices)))
        device = devices.pop() if devices else torch.device("cpu")
        layout = tuple((tuple(t.shape), t.dtype) for t in tensors)
        with self._cv:
            staging = self._staging
            if staging is None or staging.layout != layout \
                    or staging.device != device:
                staging = self._staging = _Staging(layout, device)
                self.totals["staging_allocs"] += 1
                self.totals["staging_bytes"] = staging.nbytes
                _rts.inc("checkpoint_staging_allocs")
            if self._queued is not None:
                # the pending snapshot was not taken by the writer yet:
                # its slot is reused and only the newest snapshot survives
                old, self._queued = self._queued, None
                self.totals["coalesced"] += 1
                _rts.inc("checkpoint_coalesced")
                free = old["slot"] if old["staging"] is staging else None
            else:
                free = None
            if free is None:
                free = next(s for s in staging.slots if s is not self._busy)
        with torch.no_grad():
            if tensors:
                torch._foreach_copy_(free.views, tensors)
        if device.type == "cuda":
            free.event = torch.cuda.Event()
            free.event.record()
        snap["staging"], snap["slot"] = staging, free
        self.totals["saves"] += 1
        _rts.inc("checkpoint_saves")
        if not self.async_write:
            with self._cv:
                self._busy = free
            try:
                return self._write(snap)
            finally:
                with self._cv:
                    self._busy = None
        with self._cv:
            self._queued = snap
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._thread = threading.Thread(
                    target=self._writer_loop,
                    name="mxnet-checkpoint-writer", daemon=True)
                self._thread.start()
            self._cv.notify_all()
        return None

    def _probe(self):
        """The counter probe the manifest carries: dict reads only."""
        return _rts.health_probe()

    # ---------------------------------------------------- writer thread
    def _writer_loop(self):
        while True:
            with self._cv:
                while self._queued is None and not self._stop:
                    self._cv.wait()
                if self._stop and self._queued is None:
                    return
                snap, self._queued = self._queued, None
                self._busy = snap["slot"]
                self._writing = True
            try:
                self._write(snap)
            except Exception as e:  # a failed write must not kill training
                self.last_error = "%s: %s" % (type(e).__name__, e)
                self.totals["errors"] += 1
                _rts.inc("checkpoint_errors")
                _logger().exception("async checkpoint write failed "
                                     "(step %s)", snap.get("step"))
            finally:
                with self._cv:
                    self._busy = None
                    self._writing = False
                    self._cv.notify_all()

    @property
    def busy(self):
        """True while a snapshot is pending or being written."""
        return self._queued is not None or self._writing

    def wait(self, timeout=None):
        """Block until no snapshot is pending or being written.  Returns
        False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queued is not None or self._writing:
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._cv.wait(rem)
        return True

    def close(self):
        """Write what is pending and stop the writer thread."""
        self.wait()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _host_views(self, snap):
        """The snapshot's tensors on the host: a card's slot copied into
        the pinned buffer on the staging's side stream after the
        capture's event (then the slot is free again), a CPU slot as it
        is."""
        staging, slot = snap["staging"], snap["slot"]
        if not staging.pinned:
            return slot.views
        host = staging.host_slot()
        with torch.cuda.stream(staging.stream):
            staging.stream.wait_event(slot.event)
            host.flat.copy_(slot.flat, non_blocking=True)
            done = staging.stream.record_event()
        done.synchronize()
        with self._cv:
            if self._busy is slot:
                self._busy = None
        return host.views

    # ------------------------------------------------------- the commit
    def _write(self, snap):
        t0 = time.perf_counter()
        views = self._host_views(snap)
        for lf in list(snap["params"].values()) + _tree_leaves(
                snap["trainer"].get("states"), []):
            lf.value = _numpy(views[lf.value])
        step = snap["step"]
        final = os.path.join(self.directory, "%s-%08d" % (self.prefix, step))
        tmp = "%s.tmp-%d-%d" % (final, os.getpid(), next(_tmp_seq))
        os.makedirs(tmp)
        try:
            files = {"params.npz": _write_file(
                os.path.join(tmp, "params.npz"), lambda f: np.savez(
                    f, **{k: lf.value for k, lf in snap["params"].items()}))}
            if snap["trainer"]:
                files["trainer.pkl"] = _write_file(
                    os.path.join(tmp, "trainer.pkl"),
                    lambda f: _jax_dump(snap["trainer"], f))
            if snap.get("aux") is not None:
                files["aux.pkl"] = _write_file(
                    os.path.join(tmp, "aux.pkl"), lambda f: pickle.dump(
                        snap["aux"], f, protocol=pickle.HIGHEST_PROTOCOL))
            manifest = {"version": MANIFEST_VERSION, "step": step,
                        "time": snap["time"], "pid": os.getpid(),
                        "files": files, "params": sorted(snap["params"]),
                        "has_trainer": bool(snap["trainer"]),
                        "has_aux": snap.get("aux") is not None,
                        "rng": snap["rng"], "probe": snap.get("probe"),
                        "extra": snap.get("extra"),
                        "lineage": {"previous": self.last_good["path"]
                                    if self.last_good else None}}
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f, indent=1, default=repr)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            retired = None
            if os.path.isdir(final):
                # a same-step overwrite: the old commit moves aside and is
                # deleted only after the new one lands (manager init
                # restores a .retire- directory whose replacement never
                # landed)
                retired = "%s.retire-%d-%d" % (final, os.getpid(),
                                               next(_tmp_seq))
                os.replace(final, retired)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
            if retired is not None:
                shutil.rmtree(retired, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.last_good = {"path": final, "step": step}
        self.totals["written"] += 1
        _rts.inc("checkpoint_writes")
        seconds = time.perf_counter() - t0
        _rts.inc("checkpoint_write_seconds", seconds)
        if _histogram._state["on"]:
            # the whole commit (host copy, hashes, fsyncs, renames)
            _histogram.observe("checkpoint:write", seconds)
        self._prune()
        return final

    def _prune_stale_tmp(self):
        """Remove the staging directories of crashed writes, and put back
        a ``.retire-`` directory whose replacement never landed: it is the
        only copy of its step."""
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            base, sep, _ = name.partition(".retire-")
            if sep and self._final_re.match(base):
                final = os.path.join(self.directory, base)
                with contextlib.suppress(OSError):
                    if os.path.isdir(final):
                        shutil.rmtree(path, ignore_errors=True)
                    else:
                        os.replace(path, final)
            elif ".tmp-" in name and self._final_re.match(
                    name.split(".tmp-")[0]):
                shutil.rmtree(path, ignore_errors=True)

    def _prune(self):
        """Keep the newest ``keep`` valid checkpoints; remove torn ones
        older than the newest valid one, quarantined ones beyond ``keep``
        (the newest kept) and stale staging directories."""
        entries = self._scan()
        valid = [(s, p) for s, p, m in entries if m is not None]
        for _, path in valid[self.keep:]:
            shutil.rmtree(path, ignore_errors=True)
        if valid:
            for step, path, m in entries:
                if m is None and step < valid[0][0]:
                    shutil.rmtree(path, ignore_errors=True)
        quarantined = sorted(
            n for n in os.listdir(self.directory)
            if ".corrupt-" in n
            and self._final_re.match(n.split(".corrupt-")[0]))
        for name in quarantined[:max(0, len(quarantined) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
        self._prune_stale_tmp()

    # -------------------------------------------------------- read side
    def _scan(self):
        """``[(step, path, manifest or None)]``, newest first; None for a
        missing or unreadable manifest (a torn checkpoint)."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = self._final_re.match(name)
            path = os.path.join(self.directory, name)
            if not m or not os.path.isdir(path):
                continue
            try:
                with open(os.path.join(path, MANIFEST_NAME)) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                manifest = None
            out.append((int(m.group(1)), path, manifest))
        out.sort(key=lambda e: e[0], reverse=True)
        return out

    def verify(self, path, manifest=None):
        """True when every file the manifest names has its size and
        SHA-256."""
        if manifest is None:
            try:
                with open(os.path.join(path, MANIFEST_NAME)) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                return False
        return _files_match(path, manifest.get("files", {}))

    def latest(self):
        """The newest valid checkpoint's manifest (``path`` added), or
        None.  A torn one (no manifest) or a corrupt one (a checksum
        mismatch) is skipped with a warning and quarantined (renamed with
        a ``.corrupt-`` marker, kept for inspection)."""
        for _, path, manifest in self._scan():
            if manifest is not None and self.verify(path, manifest):
                return dict(manifest, path=path)
            self.totals["corrupt_skipped"] += 1
            _rts.inc("checkpoint_corrupt_skipped")
            quarantine = "%s.corrupt-%d-%d" % (path, os.getpid(),
                                               next(_tmp_seq))
            try:
                os.replace(path, quarantine)
                _rts.inc("checkpoint_quarantined")
            except OSError:
                quarantine = path  # left in place; the next scan retries
            warn_rate_limited(
                _logger(), "checkpoint:corrupt:%s" % path, 60,
                "skipping torn/corrupt checkpoint %s (%s; quarantined as "
                "%s), falling back to the previous valid checkpoint", path,
                "no valid manifest" if manifest is None
                else "checksum mismatch", quarantine)
        return None

    def load_params(self, manifest, ctx=None):
        """``{name: NDArray}`` from a checkpoint's ``params.npz``, on
        ``ctx`` (``gpu(0)`` when None)."""
        from .ndarray import array

        with np.load(os.path.join(manifest["path"], "params.npz"),
                     allow_pickle=False) as data:
            return {k: array(data[k], ctx=ctx, dtype=data[k].dtype)
                    for k in data.files}

    def load_aux(self, manifest):
        """The ``aux`` payload saved with :meth:`save`, or None."""
        return load_aux(manifest)

    def restore(self, trainer=None, block=None, manifest=None):
        """Put the newest valid checkpoint (or ``manifest``'s) back: the
        parameters by name into ``trainer``'s and ``block``'s, copied in
        place (a captured step keeps its graphs), the updater states
        through ``Updater.restore_states`` (a new generation: a captured
        step drops its graphs and captures again), the optimizer's
        hyper-state (its update counts, on which Adam's bias correction
        and the schedules read), the random state and the step clock.
        Returns the manifest, or None when there is no valid checkpoint.
        A checkpoint the JAX package wrote restores the same way; its
        random state restores the seed alone (``random.set_state``)."""
        from . import random as _random
        from .optimizer.optimizer import read_states

        if manifest is None:
            # a snapshot queued before the restore must commit first
            self.wait()
            manifest = self.latest()
        if manifest is None:
            return None
        with np.load(os.path.join(manifest["path"], "params.npz"),
                     allow_pickle=False) as data:
            params = {k: data[k] for k in data.files}
        targets = {}
        if trainer is not None:
            targets.update({_param_name(p, i): p
                            for i, p in enumerate(trainer._params)})
        if block is not None:
            targets.update(block.collect_params().items())
        matched = 0
        for name, value in params.items():
            p = targets.get(name)
            if p is not None:
                _set_data(p, value)
                matched += 1
        if targets and params and matched == 0:
            raise MXNetError(
                "checkpoint %s matched none of the %d target parameters "
                "(it holds %s...): a name or prefix mismatch, or parameters "
                "not yet initialized (run one forward first)"
                % (manifest["path"], len(targets), sorted(params)[:3]))
        if targets and matched < len(params):
            warn_rate_limited(
                _logger(), "checkpoint:partial:%s" % manifest["path"], 60,
                "checkpoint %s: only %d of %d saved parameters matched a "
                "target by name; the rest were not restored",
                manifest["path"], matched, len(params))
        missing = sorted(n for n in targets if n not in params)
        if missing:
            warn_rate_limited(
                _logger(), "checkpoint:missing:%s" % manifest["path"], 60,
                "checkpoint %s does not cover %d target parameters (%s...); "
                "they keep their current values", manifest["path"],
                len(missing), missing[:3])
        if trainer is not None and manifest.get("has_trainer"):
            with open(os.path.join(manifest["path"], "trainer.pkl"),
                      "rb") as f:
                trainer_state = read_states(f.read())
            states = _tree_map_leaves(trainer_state.get("states", {}))
            for u in trainer._updaters:
                u.restore_states(states)
            blob = trainer_state.get("optimizer")
            if blob is not None:
                _adopt_hyper_state(trainer._optimizer, _hyper_state(blob))
        if manifest.get("rng"):
            _random.set_state(manifest["rng"])
        self.step_clock = int(manifest.get("step", 0))
        self.last_good = {"path": manifest["path"], "step": self.step_clock}
        _rts.inc("checkpoint_restores")
        return manifest

    def snapshot_info(self):
        """A JSON-serialisable view (synchronises nothing)."""
        return {"enabled": _state["on"] and bool(_GLOBAL)
                and _GLOBAL[0] is self,
                "directory": self.directory, "keep": self.keep,
                "interval": self.interval, "async": self.async_write,
                "step_clock": self.step_clock,
                "last_good": dict(self.last_good) if self.last_good
                else None,
                "last_error": self.last_error, "totals": dict(self.totals)}


def _param_name(p, index):
    """A Trainer parameter's name: its Gluon handle's (what the JAX
    package's Trainer keys by), else its index."""
    handle = getattr(p, "_handle", None)
    return handle.name if handle is not None else "param%d" % index


def _as_tensor(v):
    if hasattr(v, "data_torch"):
        return v.data_torch.detach()
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.ascontiguousarray(v))


def _set_data(p, value):
    """Copy ``value`` into a parameter in place: a Gluon ``Parameter``
    through ``set_data``, a Trainer's storage through its handle's."""
    handle = getattr(p, "_handle", None)
    if handle is not None:
        p = handle
    if hasattr(p, "set_data"):
        p.set_data(value)
        return
    src = torch.from_numpy(np.asarray(value))
    if tuple(src.shape) != tuple(p.shape):
        raise ValueError("shape mismatch: %s vs %s"
                         % (tuple(src.shape), tuple(p.shape)))
    with torch.no_grad():
        p.copy_(src)


def _tree_map_leaves(obj):
    """A loaded state tree with its leaves as their numpy values, each
    writable (a state is updated in place: an array the pickle left on a
    read-only buffer, as the JAX package's are, is copied)."""
    if isinstance(obj, _NDLeaf):
        v = obj.value
        return v if v.flags.writeable else np.array(v)
    if isinstance(obj, dict):
        return {k: _tree_map_leaves(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map_leaves(v) for v in obj)
    return obj


def _adopt_hyper_state(optimizer, hyper):
    """The hyper-state's values of the attributes ``optimizer`` has (its
    update counts, rate, multipliers, ...), but never its parameters or
    its schedule."""
    for key, value in hyper.items():
        if key in ("param_dict", "lr_scheduler"):
            continue
        if key in optimizer.__dict__:
            setattr(optimizer, key, value)


def _files_match(directory, files):
    try:
        for fname, meta in files.items():
            fpath = os.path.join(directory, fname)
            if os.path.getsize(fpath) != meta["bytes"] or \
                    _sha256(fpath) != meta["sha256"]:
                return False
    except OSError:
        return False
    return True


# ------------------------------------------------------ module surface


def enable(directory, interval=None, keep=None, async_write=None,
           prefix="ckpt"):
    """Create (or replace) the global :class:`CheckpointManager` and arm
    the step hook (:func:`on_step`).  Returns the manager."""
    if interval is None:
        interval = int(os.environ.get("MXNET_TPU_CKPT_INTERVAL", "100"))
    if keep is None:
        keep = int(os.environ.get("MXNET_TPU_CKPT_KEEP", "5"))
    mgr = CheckpointManager(directory, keep=keep, interval=interval,
                            async_write=async_write, prefix=prefix)
    if _GLOBAL:
        _GLOBAL[0].close()
    _GLOBAL[:] = [mgr]
    _state["on"] = True
    return mgr


def disable():
    """Disarm the hook; the manager writes what is pending and stays
    readable."""
    _state["on"] = False
    if _GLOBAL:
        _GLOBAL[0].close()


def is_enabled():
    return _state["on"]


def manager():
    """The global manager while enabled, else None."""
    return _GLOBAL[0] if _state["on"] and _GLOBAL else None


def on_step(trainer, pin=False):
    """The step hook of ``Trainer.step`` and ``CompiledStep.step``:
    advance the global manager's step clock and save at its interval.
    One dict read when disabled.  The clock assumes one Trainer drives
    the run; with several, disable it and call
    ``manager().save_trainer(trainer, step=...)`` for each, with distinct
    prefixes."""
    if not _state["on"]:
        return
    mgr = _GLOBAL[0]
    mgr.step_clock += 1
    if mgr.interval and mgr.step_clock % mgr.interval == 0:
        mgr.save_trainer(trainer, step=mgr.step_clock, pin=pin)


def load_aux(manifest):
    """A checkpoint's ``aux.pkl`` payload, or None when it has none (its
    checksum was verified by ``latest()`` before the manifest was handed
    out)."""
    if not manifest or not manifest.get("has_aux"):
        return None
    with open(os.path.join(manifest["path"], "aux.pkl"), "rb") as f:
        return pickle.load(f)


def auto_resume(trainer=None, block=None, zero_step=None):
    """Restore the newest valid checkpoint of the global manager into
    ``trainer``/``block``: the resumed step, or None when checkpointing is
    off or nothing valid exists.  ``zero_step`` (ZeRO's sharded resume)
    raises: it needs more than one device."""
    if zero_step is not None:
        raise MXNetError("auto_resume(zero_step=) restores ZeRO's per-rank "
                         "shards, which need more than one device; "
                         "multi-GPU training is not yet ported (ROADMAP "
                         "Queue 1 item 9)")
    mgr = manager()
    if mgr is None:
        return None
    manifest = mgr.restore(trainer=trainer, block=block)
    return None if manifest is None else int(manifest.get("step", 0))


def lineage():
    """``{"last_good_path", "step", "directory"}`` of the newest committed
    (or restored) checkpoint; None when off."""
    if not _state["on"] or not _GLOBAL:
        return None
    lg = _GLOBAL[0].last_good or {"path": None, "step": None}
    return {"last_good_path": lg["path"], "step": lg["step"],
            "directory": _GLOBAL[0].directory}


def snapshot():
    """The global manager's view, or a disabled stub."""
    return _GLOBAL[0].snapshot_info() if _GLOBAL else {"enabled": False}


def reset():
    """Disable and drop the global manager (tests)."""
    _state["on"] = False
    if _GLOBAL:
        with contextlib.suppress(Exception):
            _GLOBAL[0].close()
    _GLOBAL.clear()


# --------------------------------------------- legacy prefix/epoch API


def save_legacy(prefix, epoch, symbol, arg_params, aux_params):
    """``model.save_checkpoint``'s files (``<prefix>-symbol.json``,
    ``<prefix>-<epoch:04d>.params``) written atomically, with the sidecar
    ``<prefix>-<epoch:04d>.manifest.json`` of their checksums that
    :func:`load_legacy` checks (the JAX package's format)."""
    from .ndarray import save as nd_save

    sym_name = "%s-symbol.json" % prefix
    param_name = "%s-%04d.params" % (prefix, epoch)
    if symbol is not None:
        with atomic_write(sym_name) as tmp:
            symbol.save(tmp)
    save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
    with atomic_write(param_name) as tmp:
        nd_save(tmp, save_dict)
    names = [param_name] + ([sym_name] if symbol is not None else [])
    manifest = {"version": MANIFEST_VERSION, "epoch": int(epoch),
                "time": time.time(),
                "files": {os.path.basename(n): {"sha256": _sha256(n),
                                                "bytes": os.path.getsize(n)}
                          for n in names}}
    with atomic_write("%s-%04d.manifest.json" % (prefix, epoch)) as tmp:
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)


def load_legacy(prefix, epoch, ctx=None):
    """Check the sidecar manifest (when there is one), then load
    ``(symbol, arg_params, aux_params)``, the arrays on ``ctx``
    (``gpu(0)`` when None); a file that fails its checksum raises
    :class:`MXNetError`."""
    mpath = "%s-%04d.manifest.json" % (prefix, epoch)
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            manifest = None
        d = os.path.dirname(os.path.abspath(mpath))
        for fname, meta in (manifest or {}).get("files", {}).items():
            if not _files_match(d, {fname: meta}):
                raise MXNetError(
                    "checkpoint file %s fails its manifest checksum (%s): "
                    "the file is torn or corrupt; restore an earlier epoch "
                    "or a CheckpointManager checkpoint"
                    % (os.path.join(d, fname), mpath))
    from .ndarray import load as nd_load
    from .symbol import load as sym_load

    symbol = sym_load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd_load("%s-%04d.params" % (prefix, epoch), ctx=ctx).items():
        kind, name = k.split(":", 1)
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def _activate_from_env():
    directory = os.environ.get("MXNET_TPU_CKPT")
    if directory:
        enable(directory)
        return True
    return False


_activate_from_env()
