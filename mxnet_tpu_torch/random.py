"""Random streams of the PyTorch port.

Counterpart of ``mxnet_tpu/random.py`` (reference: python/mxnet/random.py
``seed``).  The JAX package derives keys from a seed and a counter; the
port keeps one explicit ``torch.Generator`` per device, made from the
seed, and never draws from PyTorch's global generator; host-side draws
(the Module API's initializers) come from one
``numpy.random.RandomState`` made from the same seed.  The streams
cannot match the JAX package's threefry keys: tests compare laws, not
draws.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .context import as_torch_device

__all__ = ["seed", "generator", "host_rng"]

_lock = threading.Lock()
_state = {"seed": None, "gens": {}, "host": None}


def seed(seed_state, ctx="all"):
    """Seed the port's generators: every device's stream restarts from
    ``seed_state`` (``ctx`` is accepted and, as in the JAX package,
    ignored)."""
    del ctx
    with _lock:
        _state["seed"] = int(seed_state)
        _state["gens"].clear()
        _state["host"] = None


def generator(device):
    """The generator of ``device``, made at first use from the last
    :func:`seed` (or from a random seed when none was set)."""
    dev = as_torch_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _state["gens"].get(dev)
        if gen is None:
            if _state["seed"] is None:
                _state["seed"] = int(np.random.randint(0, 2**31 - 1))
            gen = torch.Generator(device=dev).manual_seed(_state["seed"])
            _state["gens"][dev] = gen
        return gen


def host_rng():
    """The host's ``numpy.random.RandomState``, made at first use from the
    last :func:`seed` (or from a random seed when none was set)."""
    with _lock:
        if _state["host"] is None:
            if _state["seed"] is None:
                _state["seed"] = int(np.random.randint(0, 2**31 - 1))
            _state["host"] = np.random.RandomState(_state["seed"])
        return _state["host"]
