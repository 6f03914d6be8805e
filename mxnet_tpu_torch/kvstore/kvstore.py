"""The KVStore of the PyTorch port, on one device.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py:44-233,598-624``
(reference: src/kvstore/kvstore_local.h).  ``create`` takes the
single-process names, ``local`` (and its ``local_*`` forms),
``device``, ``nccl`` and ``tpu``, all one store; a ``dist*`` name raises
until multi-GPU training is ported (ROADMAP Queue 1 item 9).

``push`` sums a list of values (one per device in MXNet; one here) and,
with an updater set (``set_updater``, or ``set_optimizer``'s), updates
the key's stored value in place; without one the sum replaces it.
``pull`` copies the stored value out.  A ``Module`` that trains through
a store hands it its bound parameters themselves (:meth:`KVStore.adopt`),
as a bucket switch shares storage: an update through the store is the
optimizer's update of the bound tensor, and a pull into that tensor
copies nothing.  ``copied_bytes`` counts the bytes the store's pushes and
pulls have copied.

``save_optimizer_states`` writes the updater's states as the JAX
package's store writes them, a pickle of ``{key: state}`` whose arrays
the JAX package reads back as its NDArrays; ``load_optimizer_states``
reads either package's file through ``Updater.set_states``, the reader
of every state file of this package.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from .. import checkpoint as _ckpt
from .. import runtime_stats as _rts
from ..base import MXNetError
from ..ndarray import NDArray
from ..optimizer import Optimizer, get_updater
from .gradient_compression import GradientCompression

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu",
          "local_allreduce_device", "device", "nccl", "tpu")


def create(name="local"):
    """A store by name (reference: src/kvstore/kvstore.cc)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in _LOCAL:
        return KVStore(name)
    if name.startswith("dist"):
        raise MXNetError("kvstore %r: distributed stores are not ported; "
                         "multi-GPU training waits for ROADMAP Queue 1 "
                         "item 9" % name)
    raise MXNetError("unknown KVStore type %r" % name)


def _tensor(v):
    return v.data_torch if isinstance(v, NDArray) else v


class KVStore:
    """The single-process store (reference: KVStoreLocal)."""

    def __init__(self, type_name="local"):
        self._type = type_name
        self._store = {}
        self._updater = None
        self._tensor_updater = False
        self._optimizer = None
        self._compression = None
        self.copied_bytes = 0

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        """Nothing to wait for with one worker."""

    # ------------------------------------------------------------- core
    def init(self, key, value):
        """Store a copy of each value under its key (a key or a list of
        keys with a list of values)."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = NDArray(_tensor(v).detach().clone())

    def adopt(self, key, value):
        """Hold the NDArray ``value`` itself under ``key`` (one device: a
        bound parameter is the store's value; an earlier value under the
        key is dropped)."""
        self._store[key] = value

    def push(self, key, value, priority=0):
        """Sum each key's pushed values; update its stored value with the
        updater if one is set, else replace it with the sum."""
        del priority
        _rts.inc("kvstore_pushes")
        keys, values = _key_value_list(key, value)
        for k, vlist in zip(keys, values):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            merged = _tensor(vlist[0])
            if len(vlist) > 1:
                merged = torch.stack([_tensor(v) for v in vlist]).sum(0)
            if self._compression is not None:
                merged = self._compression.compress_decompress(k, merged)
            stored = self._store[k]
            if self._updater is None:
                self._store[k] = NDArray(merged.detach().clone())
                self.copied_bytes += merged.numel() * merged.element_size()
            elif self._tensor_updater:
                self._updater(_key_int(k), merged, stored.data_torch)
            else:
                self._updater(_key_int(k), NDArray(merged), stored)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into its ``out`` arrays (nothing
        moves into the stored array itself)."""
        del priority, ignore_sparse
        assert out is not None
        _rts.inc("kvstore_pulls")
        keys, outs = _key_value_list(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            src = self._store[k].data_torch
            for o in olist:
                dst = _tensor(o)
                if dst.data_ptr() != src.data_ptr():
                    with torch.no_grad():
                        dst.copy_(src)
                    self.copied_bytes += src.numel() * src.element_size()

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    # ------------------------------------------------------------- config
    def set_updater(self, updater):
        """``updater(key, pushed, stored)`` on NDArrays at every push."""
        self._updater = updater
        self._tensor_updater = False

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Update at every push through ``optimizer``'s updater (on the
        store's tensors)."""
        if not isinstance(optimizer, Optimizer):
            raise TypeError("optimizer must be an Optimizer")
        self._optimizer = optimizer
        self._updater = get_updater(optimizer)
        self._tensor_updater = True

    def set_gradient_compression(self, compression_params):
        """Two-bit compression of every pushed sum (``{"type": "2bit",
        "threshold": t}``)."""
        params = dict(compression_params)
        if params.get("type", "2bit") != "2bit":
            raise MXNetError("only 2bit compression is supported")
        self._compression = GradientCompression(
            threshold=float(params.get("threshold", 0.5)))

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The updater's states, written through a temporary file and a
        rename; the JAX package's store reads them (``dump_optimizer``
        adds the optimizer, which only this package reads)."""
        assert self._updater is not None, "updater is not set"
        if dump_optimizer:
            payload = self._updater.get_states(dump_optimizer=True)
        else:
            buf = io.BytesIO()
            _JaxPickler(buf, protocol=4).dump(self._updater.states)
            payload = buf.getvalue()
        with _ckpt.atomic_write(fname) as tmp:
            with open(tmp, "wb") as f:
                f.write(payload)

    def load_optimizer_states(self, fname):
        """Read what either package's ``save_optimizer_states`` wrote
        (through the updater's one reader, ``optimizer.read_states``); a
        state whose key the store does not hold raises."""
        assert self._updater is not None, "updater is not set"
        with open(fname, "rb") as f:
            data = f.read()
        keys = {_key_int(k): _key_int(k) for k in self._store}
        self._updater.set_states(data, keys)


# ------------------------------------------------------------ state files


class _JaxArray:
    """What the JAX package's ``ndarray.array(numpy)`` is, in a pickle
    this package writes: a reference by name, never imported here."""

    def __init__(self, value):
        self.value = value


class _JaxPickler(pickle._Pickler):
    """Writes each tensor or numpy array as a call of the JAX package's
    ``mxnet_tpu.ndarray.ndarray.array`` on its numpy value, so that the
    JAX package loads its own NDArrays."""

    def save(self, obj, save_persistent_id=True):
        if isinstance(obj, torch.Tensor):
            obj = _JaxArray(obj.detach().cpu().float().numpy()
                            if obj.dtype == torch.bfloat16
                            else obj.detach().cpu().numpy())
        elif isinstance(obj, np.ndarray):
            obj = _JaxArray(obj)
        if isinstance(obj, _JaxArray):
            self.write(pickle.GLOBAL + b"mxnet_tpu.ndarray.ndarray\narray\n")
            super().save(np.ascontiguousarray(obj.value))
            self.write(pickle.TUPLE1 + pickle.REDUCE)
            return
        super().save(obj, save_persistent_id)


def _key_value(key, value):
    if isinstance(key, (str, int)):
        return [key], [value]
    assert len(key) == len(value)
    return list(key), list(value)


def _key_value_list(key, value):
    """``(keys, [values of each key])``."""
    if isinstance(key, (str, int)):
        return [key], [list(value) if isinstance(value, (list, tuple))
                       else [value]]
    return list(key), [list(v) if isinstance(v, (list, tuple)) else [v]
                       for v in value]


def _key_int(key):
    if isinstance(key, int):
        return key
    try:
        return int(key)
    except (TypeError, ValueError):
        return key
