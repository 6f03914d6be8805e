"""Random streams of the PyTorch port.

Counterpart of ``mxnet_tpu/random.py`` (reference: python/mxnet/random.py
``seed``).  The JAX package derives keys from a seed and a counter; the
port keeps one explicit ``torch.Generator`` per device, made from the
seed, and never draws from PyTorch's global generator; host-side draws
(the Module API's initializers) come from one
``numpy.random.RandomState`` made from the same seed.  The streams
cannot match the JAX package's threefry keys: tests compare laws, not
draws.

:func:`get_state` and :func:`set_state` carry the whole random state, the
seed, each device generator's state and the host ``RandomState``, as a
JSON-serialisable dict (a checkpoint's manifest stores it), so a resumed
run continues the draws of the run that saved it, Dropout's inside a
captured CUDA graph included (a replay reads its generator's offset).
"""

from __future__ import annotations

import base64
import threading

import numpy as np
import torch

from .context import as_torch_device

__all__ = ["seed", "generator", "host_rng", "get_state", "set_state"]

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


def _seed_locked():
    if _state["seed"] is None:
        _state["seed"] = int(np.random.randint(0, 2**31 - 1))
    return _state["seed"]


def generator(device):
    """The generator of ``device``, made at first use from the last
    :func:`seed` (or from a random seed when none was set)."""
    dev = as_torch_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _state["gens"].get(dev)
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(_seed_locked())
            _state["gens"][dev] = gen
        return gen


def host_rng():
    """The host's ``numpy.random.RandomState``, made at first use from the
    last :func:`seed` (or from a random seed when none was set)."""
    with _lock:
        if _state["host"] is None:
            _state["host"] = np.random.RandomState(_seed_locked())
        return _state["host"]


def get_state():
    """The whole random state as a JSON-serialisable dict: ``seed``,
    ``gens`` (each device generator made so far, by device name, its
    ``get_state()`` bytes in base64) and ``host`` (the host
    ``RandomState``'s state, or None before its first use).  Reading it
    synchronises nothing: a CUDA generator's state is its seed and offset
    on the host."""
    with _lock:
        host = _state["host"]
        if host is not None:
            kind, keys, pos, has_gauss, gauss = host.get_state()
            host = [kind, keys.tolist(), int(pos), int(has_gauss),
                    float(gauss)]
        return {"seed": _seed_locked(),
                "gens": {str(dev): base64.b64encode(
                    bytes(gen.get_state().tolist())).decode("ascii")
                    for dev, gen in _state["gens"].items()},
                "host": host}


def set_state(state):
    """Restore what :func:`get_state` gave: the seed, every generator it
    names (made first if need be, its state set in place, so a graph that
    registered it reads the restored offset at its next replay) and the
    host ``RandomState``.  A dict without ``gens`` (the JAX package's
    ``{"seed", "counter"}``, whose threefry key chain no PyTorch generator
    can continue) restores the seed alone, as :func:`seed` does."""
    if "gens" not in state:
        seed(state["seed"])
        return
    gens = {torch.device(d): torch.tensor(list(base64.b64decode(b)),
                                          dtype=torch.uint8)
            for d, b in state["gens"].items()}
    with _lock:
        _state["seed"] = int(state["seed"])
        for dev, gen in _state["gens"].items():
            if dev not in gens:
                # made after the save: from the seed, as at its first use
                gen.manual_seed(_state["seed"])
        for dev, value in gens.items():
            gen = _state["gens"].get(dev)
            if gen is None:
                gen = _state["gens"][dev] = torch.Generator(device=dev)
            gen.set_state(value)
        host = state.get("host")
        if host is None:
            _state["host"] = None
        else:
            rs = _state["host"] or np.random.RandomState()
            rs.set_state((host[0], np.asarray(host[1], np.uint32),
                          host[2], host[3], host[4]))
            _state["host"] = rs
