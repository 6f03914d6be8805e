"""Automatic names of the PyTorch port's symbols.

Counterpart of ``mxnet_tpu/name.py`` and ``mxnet_tpu/base.py``'s
``NameManager`` (reference: python/mxnet/name.py): one counter a hint,
so an unnamed node gets the name the JAX package gives it
(``fullyconnected0``, ``activation1``, ...) and symbol JSON and parameter
names cross between the packages unchanged.  The managers are a
thread-local stack; ``with NameManager():`` starts fresh counters.
"""

from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Gives each unnamed node ``<hint><count>`` (the hint lower-cased)."""

    _state = threading.local()

    def __init__(self):
        self._counter = {}

    @classmethod
    def _stack(cls):
        stack = getattr(NameManager._state, "value", None)
        if not stack:
            stack = NameManager._state.value = [NameManager()]
        return stack

    @classmethod
    def current(cls):
        return cls._stack()[-1]

    def __enter__(self):
        self._stack().append(self)
        return self

    def __exit__(self, *exc):
        self._stack().pop()

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return "%s%d" % (hint, count)


class Prefix(NameManager):
    """Prepends ``prefix`` to every name, the explicit ones too."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
