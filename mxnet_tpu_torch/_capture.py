"""CUDA-graph capture shared by ``HybridBlock.hybridize()`` and
``GluonTrainStep``: the port's counterpart of ``jax.jit`` and its caches.

A graph is captured once per signature, after one eager warm-up run
whose effects on the state are undone (:func:`warm_up`), so that every
call advances the state exactly once.  Capture and warm-up run on one
side stream per device; replays run on the caller's stream.  The port's
random generator of the device (:func:`~mxnet_tpu_torch.random.generator`)
is registered with every graph, so each replay draws new numbers.  A
capture that fails raises :class:`MXNetError`; nothing falls back to
eager execution.

While a captured program runs a block's forward (:func:`staging`), the
block and its children run their plain forward, never a graph of their
own, as the JAX package traces a hybridized child into its parent's
program.
"""

from __future__ import annotations

import threading

import torch

from . import random as _random
from .base import MXNetError

__all__ = ["staging", "is_staging", "warm_up", "capture"]

_local = threading.local()
_streams: dict = {}


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


def _stream(device):
    s = _streams.get(device)
    if s is None:
        s = _streams[device] = torch.cuda.Stream(device)
    return s


def warm_up(fn, state, device):
    """Run ``fn`` once eagerly on the capture stream (the first use of
    every kernel and library handle, cuDNN's plans, the allocator's
    blocks), then put back the tensors of ``state`` and the device's
    generator as they were."""
    gen = _random.generator(device)
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
        graph.register_generator_state(_random.generator(device))
        with torch.cuda.graph(graph, pool=pool, stream=_stream(device)):
            out = fn()
    except (RuntimeError, MXNetError) as e:
        raise MXNetError("CUDA-graph capture failed: %s" % e) from e
    return graph, out
