"""CUDA-graph capture shared by ``HybridBlock.hybridize()`` and
``GluonTrainStep``: the port's counterpart of ``jax.jit`` and its caches.

A graph is captured once per signature, after one eager warm-up run
whose effects on the state are undone (:func:`warm_up`), so that every
call advances the state exactly once.  Capture and warm-up run on one
side stream per device, one thread at a time (:data:`lock`); replays run
on the caller's stream.  A capture is made in PyTorch's thread-local
error mode, so other threads may go on replaying, copying and allocating
while it runs (a server's lazy bucket build).  What a capture keeps is
made outside ``torch.inference_mode()`` (:func:`normal_tensors`), so a
graph captured under that mode replays outside it and the reverse.  The
port's random generator of the device
(:func:`~mxnet_tpu_torch.random.generator`) is registered with every
graph, so each replay draws new numbers.  A capture that fails raises
:class:`MXNetError`; nothing falls back to eager execution.

While a captured program runs a block's forward (:func:`staging`), the
block and its children run their plain forward, never a graph of their
own, as the JAX package traces a hybridized child into its parent's
program.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import random as _random
from .base import MXNetError

__all__ = ["staging", "is_staging", "normal_tensors", "warm_up", "capture",
           "lock"]

_local = threading.local()
_streams: dict = {}
# warm-ups and captures share one side stream a device: one at a time
lock = threading.RLock()


class staging:
    """Blocks called inside this scope run their plain forward."""

    def __enter__(self):
        self._old = getattr(_local, "staging", False)
        _local.staging = True
        return self

    def __exit__(self, *exc):
        _local.staging = self._old


def is_staging():
    return getattr(_local, "staging", False)


def normal_tensors():
    """A scope outside ``torch.inference_mode()`` with the caller's grad
    mode kept (``inference_mode(False)`` alone turns grad mode on): the
    tensors made in it are normal ones, which an in-place copy may update
    in any mode."""
    grad = torch.is_grad_enabled()
    scope = contextlib.ExitStack()
    scope.enter_context(torch.inference_mode(False))
    scope.enter_context(torch.set_grad_enabled(grad))
    return scope


def _stream(device):
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    s = _streams.get(device)
    if s is None:
        # from the high-priority pool: PyTorch hands out default-priority
        # streams (a server's workers', a caller's) round-robin from a pool
        # of 32, so one made later would be this very stream, and its work
        # would land in another thread's capture
        s = _streams[device] = torch.cuda.Stream(device, priority=-1)
    return s


def warm_up(fn, state, device):
    """Run ``fn`` once eagerly on the capture stream (the first use of
    every kernel and library handle, cuDNN's plans, the allocator's
    blocks), then put back the tensors of ``state`` and the device's
    generator as they were."""
    gen = _random.generator(device)
    with lock:
        saved = [t.detach().clone() for t in state]
        gen_state = gen.get_state()
        side, main = _stream(device), torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        gen.set_state(gen_state)


def capture(fn, device, pool=None):
    """``(graph, fn())``: ``fn`` captured into a new CUDA graph (its
    memory from the graph's private pool, or from ``pool``)."""
    graph = torch.cuda.CUDAGraph()
    try:
        with lock, normal_tensors():
            graph.register_generator_state(_random.generator(device))
            with torch.cuda.graph(graph, pool=pool, stream=_stream(device),
                                  capture_error_mode="thread_local"):
                out = fn()
    except (RuntimeError, MXNetError) as e:
        raise MXNetError("CUDA-graph capture failed: %s" % e) from e
    return graph, out
