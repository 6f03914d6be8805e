"""Attribute scopes of the PyTorch port's symbols.

Counterpart of ``mxnet_tpu/attribute.py`` (reference:
python/mxnet/attribute.py): ``with AttrScope(lr_mult="0.1"):`` attaches
string attributes to every symbol made inside it; nested scopes merge at
entry, the inner one winning.
"""

from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    """A scope of string attributes for the symbols made inside it."""

    _state = threading.local()

    def __init__(self, **kwargs):
        self._own = {str(k): str(v) for k, v in kwargs.items()}
        self._attr = dict(self._own)

    @classmethod
    def _stack(cls):
        stack = getattr(AttrScope._state, "value", None)
        if not stack:
            stack = AttrScope._state.value = [AttrScope()]
        return stack

    @classmethod
    def current(cls):
        return cls._stack()[-1]

    def __enter__(self):
        stack = self._stack()
        self._attr = dict(stack[-1]._attr)
        self._attr.update(self._own)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._stack().pop()

    def get(self, attr):
        """The scope's attributes updated by ``attr`` (a new dict)."""
        ret = dict(self._attr)
        ret.update(attr or {})
        return ret
