"""The DataLoader of the PyTorch port.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py:42-118`` (reference:
python/mxnet/gluon/data/dataloader.py): batches of a dataset through a
batch sampler (``batch_size``, ``shuffle``, ``sampler``, ``last_batch``,
``batch_sampler``), assembled by ``batchify_fn`` (default: samples
stacked, a tuple sample element-wise), with ``num_workers`` threads
assembling batches ahead (``prefetch`` batches, default twice the
workers), as the JAX package's thread pool.

Every batch is NDArrays on the current context
(:func:`~mxnet_tpu_torch.context.current_context`, read when the
iteration starts): samples on the host are stacked on the host and the
batch copied over once.  With ``pin_memory=True`` a batch bound for the
card is staged in page-locked host memory and copied asynchronously on
the current stream; the pinned blocks are a ring a batch signature
(``prefetch + 2`` deep), each reused once its last copy is done, so no
pinned block is made a batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import ndarray
from ...context import resolve_device
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays where they lie, tuples
    element-wise, anything else through numpy on the host."""
    if isinstance(data[0], ndarray.NDArray):
        return ndarray.NDArray(torch.stack([d.data_torch for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    return _host(np.asarray(data))


def _host(arr):
    """A numpy array as a host NDArray; 64-bit types narrow to 32 bits,
    as the JAX package's arrays do."""
    narrow = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
    if arr.dtype in narrow:
        arr = arr.astype(narrow[arr.dtype])
    return ndarray.NDArray(torch.from_numpy(np.ascontiguousarray(arr)))


class _PinnedStage:
    """Host-to-card copies through reused page-locked blocks: ``depth``
    blocks a (shape, dtype), each with the event of its last copy.
    :meth:`copy` stages a host tensor; :meth:`take` hands out a free
    block to fill in place and :meth:`send` copies it over, so a batch
    assembled in the block itself crosses with one copy."""

    def __init__(self, depth):
        self._depth = depth
        self._rings = {}
        self.blocks = 0  # page-locked blocks made so far

    def take(self, shape, dtype):
        """A page-locked block of ``shape`` and ``dtype`` whose last copy
        is done: ``[tensor, event]``."""
        key = (tuple(shape), dtype)
        ring = self._rings.setdefault(key, [])
        if len(ring) < self._depth:
            slot = [torch.empty(key[0], dtype=key[1], pin_memory=True), None]
            self.blocks += 1
            ring.append(slot)
        else:
            slot = ring.pop(0)
            ring.append(slot)
            if slot[1] is not None:
                slot[1].synchronize()
        return slot

    def send(self, slot, device):
        """The block's tensor copied to ``device`` on its current stream,
        asynchronously; the block is free again once the copy is done."""
        out = slot[0].to(device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(device))
        return out

    def copy(self, t, device):
        slot = self.take(t.shape, t.dtype)
        slot[0].copy_(t)
        return self.send(slot, device)


class DataLoader:
    """Mini-batches of ``dataset`` (see the module docstring)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        del thread_pool  # the workers are threads either way
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with a custom "
                                 "sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size/shuffle/sampler/last_batch must not "
                             "be set when batch_sampler is specified")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._pin_memory = pin_memory
        self._stage = _PinnedStage(self._prefetch + 2) if pin_memory \
            else None

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def _to_device(self, batch, device):
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._to_device(b, device) for b in batch)
        if isinstance(batch, np.ndarray):
            batch = _host(batch)
        if not isinstance(batch, ndarray.NDArray):
            return batch
        t = batch.data_torch
        if t.device == device:
            return batch
        if self._stage is not None and device.type == "cuda" \
                and t.device.type == "cpu":
            return ndarray.NDArray(self._stage.copy(t, device))
        return ndarray.NDArray(t.to(device))

    def __iter__(self):
        device = resolve_device(None)
        batches = self._batches() if self._num_workers == 0 \
            else self._prefetched()
        for batch in batches:
            yield self._to_device(batch, device)

    def _batches(self):
        for indices in self._batch_sampler:
            yield self._load_batch(indices)

    def _prefetched(self):
        """Batches assembled by the worker threads, at most ``prefetch``
        (at least 2) ahead."""
        pool = ThreadPoolExecutor(max_workers=self._num_workers)
        depth = max(2, self._prefetch)
        out_q = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def producer():
            try:
                futures = []
                for indices in self._batch_sampler:
                    if stop.is_set():
                        return
                    futures.append(pool.submit(self._load_batch, indices))
                    while len(futures) >= depth:
                        out_q.put(("ok", futures.pop(0).result()))
                for f in futures:
                    out_q.put(("ok", f.result()))
                out_q.put(("done", None))
            except Exception as e:  # handed to the consumer
                out_q.put(("err", e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, val = out_q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise val
                yield val
        finally:
            stop.set()
            while t.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    t.join(0.01)
            pool.shutdown(wait=True)
