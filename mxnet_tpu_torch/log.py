"""Logging helpers of the PyTorch port (reference: python/mxnet/log.py;
the JAX package's ``mxnet_tpu/log.py``, of which this is the part the
serving layer uses).

``get_logger`` attaches a glog-style formatter: one colored severity
letter + timestamp + pid + source location, then the message.
``warn_rate_limited`` and ``warn_once`` keep telemetry paths that warn
from hot loops to one line an interval; ``rank_suffix_path`` keeps a
multi-process run's output files apart.
"""

from __future__ import annotations

import logging
import os
import sys
import time

__all__ = ["get_logger", "getLogger", "warn_rate_limited", "warn_once",
           "reset_rate_limits", "process_identity", "rank_suffix_path",
           "CRITICAL", "ERROR", "WARNING", "INFO", "DEBUG", "NOTSET"]

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_COLORS = ((logging.WARNING, "\x1b[31m"), (logging.INFO, "\x1b[32m"),
           (logging.NOTSET, "\x1b[34m"))
_LABELS = {logging.CRITICAL: "C", logging.ERROR: "E", logging.WARNING: "W",
           logging.INFO: "I", logging.DEBUG: "D"}


class _GlogFormatter(logging.Formatter):
    def __init__(self):
        super().__init__(datefmt="%m%d %H:%M:%S")

    def format(self, record):
        color = next(c for lvl, c in _COLORS if record.levelno >= lvl)
        label = _LABELS.get(record.levelno, "U")
        self._style._fmt = (
            color + label +
            "%(asctime)s %(process)d %(pathname)s:%(funcName)s:%(lineno)d"
            "]\x1b[0m %(message)s")
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=logging.WARNING):
    """A logger with the glog-style formatter attached once."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mxtpu_log_init", False):
        logger.setLevel(level)
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_GlogFormatter())
    logger.addHandler(handler)
    logger.setLevel(level)
    if name is not None:  # don't double-print through the root handler
        logger.propagate = False
    logger._mxtpu_log_init = True
    return logger


def process_identity():
    """This process's rank and role under the ``DMLC_*``/``MXTPU_*``
    launch contract, or None when it runs alone:
    ``{"role": "worker"|"server", "rank": int, "num_workers": int}``.
    Read from the environment at each call."""
    def _int(v, default):
        # a malformed value must never break a warning call
        try:
            return int(v)
        except (TypeError, ValueError):
            return default

    env = os.environ
    role = env.get("DMLC_ROLE")
    nw = _int(env.get("DMLC_NUM_WORKER"), 1)
    if role == "server":
        rank = env.get("MXTPU_PS_SERVER_ID", env.get("DMLC_SERVER_ID"))
        return {"role": "server", "rank": _int(rank, 0), "num_workers": nw}
    wid = env.get("DMLC_WORKER_ID", env.get("JAX_PROCESS_ID"))
    if role is None and wid is None:
        return None
    return {"role": role or "worker", "rank": _int(wid, 0),
            "num_workers": nw}


def rank_suffix_path(path):
    """``path`` for this process: rank-0 workers and single-process runs
    keep it; every other rank, and servers, get
    ``<base>.<role><rank><ext>``, so no process overwrites rank 0's file.
    A path that already carries the token is returned as it is."""
    if not path:
        return path
    ident = process_identity()
    if ident is None:
        return path
    role, rank = ident["role"], ident["rank"]
    if role != "server" and rank == 0:
        return path
    token = ".%s%d" % (role, rank)
    base, ext = os.path.splitext(path)
    if base.endswith(token) or ext == token:
        return path
    return base + token + ext


# key -> monotonic time of the last emitted warning (best effort: a race
# costs at most one duplicate or dropped warning)
_rate_state: dict = {}


def warn_rate_limited(logger, key, interval, msg, *args):
    """``logger.warning(msg, *args)`` at most once per ``interval``
    seconds per ``key``; True when it was emitted.  Under a distributed
    launch the message is prefixed with this process's role and rank."""
    now = time.monotonic()
    last = _rate_state.get(key)
    if last is not None and now - last < interval:
        return False
    _rate_state[key] = now
    ident = process_identity()
    if ident is not None:
        msg = "[%s %d] %s" % (ident["role"], ident["rank"], msg)
    logger.warning(msg, *args)
    return True


def warn_once(logger, key, msg, *args):
    """``logger.warning(msg, *args)`` once per ``key`` for the life of the
    process (re-armed by :func:`reset_rate_limits`)."""
    return warn_rate_limited(logger, key, float("inf"), msg, *args)


def reset_rate_limits(prefix=None):
    """Re-arm rate-limited warnings (all keys, or those under a prefix)."""
    if prefix is None:
        _rate_state.clear()
        return
    for k in [k for k in _rate_state if k.startswith(prefix)]:
        del _rate_state[k]


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """Deprecated alias of :func:`get_logger` (reference parity)."""
    import warnings

    warnings.warn("getLogger is deprecated; use get_logger",
                  DeprecationWarning, stacklevel=2)
    return get_logger(name, filename, filemode, level)
