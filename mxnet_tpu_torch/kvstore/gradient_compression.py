"""Two-bit gradient compression with error feedback.

Counterpart of ``mxnet_tpu/kvstore/gradient_compression.py`` (reference:
src/kvstore/gradient_compression.h, kTwoBit): each value of a gradient
plus the key's residual becomes ``+threshold``, ``-threshold`` or 0, and
what that drops is the residual added to the key's next gradient.  Only
the numerics are kept: the store is in the process, so nothing is
bit-packed for a wire.
"""

from __future__ import annotations

import torch

__all__ = ["GradientCompression"]


class GradientCompression:
    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self._residuals = {}

    def get_params(self):
        return {"type": "2bit", "threshold": self.threshold}

    @torch.no_grad()
    def compress_decompress(self, key, grad):
        """``grad`` (a tensor) quantized and dequantized with ``key``'s
        residual, which it updates."""
        res = self._residuals.get(key)
        g = grad if res is None else grad + res
        t = torch.full((), self.threshold, dtype=grad.dtype,
                       device=grad.device)
        out = (g >= t).to(grad.dtype) * t - (g <= -t).to(grad.dtype) * t
        self._residuals[key] = g - out
        return out
