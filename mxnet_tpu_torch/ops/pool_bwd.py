"""Max-pooling backward (dX) of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/pallas_pool.py``.  Layout NHWC.  Each
window's ``dy`` goes to the window's first argmax: tap 0 first, then
``v > m`` strictly in row-major tap order, taps in the padding reading
``-inf`` (XLA's select tie-break, ``pallas_pool.py:66``).  A window whose
first argmax is a padded tap gives its ``dy`` to no pixel.  ``pad`` is
the low-side padding; the high side is whatever ``dy``'s size needs.

- :func:`maxpool_bwd_reference` is the plain version.
- :func:`maxpool_bwd` launches the hand-written Hopper kernel of
  ``csrc/maxpool_bwd.cu`` on CUDA tensors (which replaces the Pallas
  ``_bwd_kernel``) and takes the plain version on CPU tensors; on the
  card it never falls back.  It counts its launches in
  ``maxpool_bwd.launches``.

Both sum the ``dy`` a pixel receives in float32, in window order (``oy``,
then ``ox``, ascending), and round once to ``dy``'s dtype, so on the card
the kernel equals the plain version bit for bit.  (The JAX kernel
accumulates in ``dy``'s dtype.)
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..base import MXNetError

__all__ = ["maxpool_bwd", "maxpool_bwd_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 255  # the kernel keeps each window's argmax tap in one byte


def _padded(x, dy, kernel, stride, pad):
    """x in float32, padded with ``-inf``: ``pad`` rows and columns on the
    low side, as many on the high side as the last window needs."""
    n, h, w, c = x.shape
    oh, ow = dy.shape[1], dy.shape[2]
    hp = max(pad[0] + h, (oh - 1) * stride[0] + kernel[0])
    wp = max(pad[1] + w, (ow - 1) * stride[1] + kernel[1])
    xp = torch.full((n, hp, wp, c), float("-inf"), dtype=torch.float32,
                    device=x.device)
    xp[:, pad[0]:pad[0] + h, pad[1]:pad[1] + w] = x.float()
    return xp


def _tap_view(t, r, s, stride, oh, ow):
    """The (N, OH, OW, C) view of tap (r, s) of every window in ``t``."""
    return t[:, r:r + stride[0] * (oh - 1) + 1:stride[0],
             s:s + stride[1] * (ow - 1) + 1:stride[1]]


def _first_argmax(x, dy, kernel, stride, pad):
    """(N, OH, OW, C) int64: each window's first argmax tap, and the
    padded input it was taken from."""
    kh, kw = kernel
    oh, ow = dy.shape[1], dy.shape[2]
    xp = _padded(x, dy, kernel, stride, pad)
    m = idx = None
    for t in range(kh * kw):
        v = _tap_view(xp, t // kw, t % kw, stride, oh, ow)
        if m is None:
            m, idx = v, torch.zeros(v.shape, dtype=torch.int64,
                                    device=x.device)
        else:
            take = v > m  # strict: ties keep the earlier tap
            m = torch.where(take, v, m)
            idx = torch.where(take, torch.full_like(idx, t), idx)
    return idx, xp


def maxpool_bwd_reference(x, dy, kernel, stride, pad=(0, 0)):
    """Plain dX (N, H, W, C) in ``dy``'s dtype."""
    kh, kw = kernel
    n, h, w, c = x.shape
    oh, ow = dy.shape[1], dy.shape[2]
    idx, xp = _first_argmax(x, dy, kernel, stride, pad)
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    dyf = dy.float()
    zero = torch.zeros_like(dyf)
    # taps in reverse order add each pixel's windows in window order: a
    # pixel's tap row falls as its window row rises
    for t in reversed(range(kh * kw)):
        view = _tap_view(dxp, t // kw, t % kw, stride, oh, ow)
        view += torch.where(idx == t, dyf, zero)
    return dxp[:, pad[0]:pad[0] + h, pad[1]:pad[1] + w].to(dy.dtype)


def _check(x, dy, kernel, stride, pad):
    if x.dim() != 4 or dy.dim() != 4:
        raise MXNetError("maxpool_bwd takes NHWC x and dy")
    kh, kw = kernel
    sy, sx = stride
    if min(kh, kw, sy, sx) < 1 or min(pad) < 0 or kh * kw > MAX_TAPS:
        raise MXNetError("maxpool_bwd takes windows of 1 to %d taps, "
                         "strides >= 1 and pads >= 0 (got kernel %s, "
                         "stride %s, pad %s)" % (MAX_TAPS, kernel, stride,
                                                 pad))
    if dy.shape[0] != x.shape[0] or dy.shape[3] != x.shape[3]:
        raise MXNetError("maxpool_bwd: dy %s does not match x %s"
                         % (tuple(dy.shape), tuple(x.shape)))
    if x.device != dy.device:
        raise MXNetError("x and dy lie on different devices")
    if x.dtype != dy.dtype or x.dtype not in _DTYPE_CODES:
        raise MXNetError("maxpool_bwd takes x and dy of one dtype, float32 "
                         "or bfloat16 (got %s, %s)" % (x.dtype, dy.dtype))
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise MXNetError("maxpool_bwd takes contiguous NHWC x and dy")
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError("maxpool_bwd runs on CPU or CUDA tensors, not %s"
                         % x.device)


def maxpool_bwd(x, dy, kernel, stride, pad=(0, 0)):
    """dX of an NHWC max pool: x (N, H, W, C) the forward's input, dy
    (N, OH, OW, C) the output's gradient, contiguous and of one dtype
    (float32 or bfloat16); returns (N, H, W, C) in that dtype."""
    kernel, stride, pad = tuple(kernel), tuple(stride), tuple(pad)
    _check(x, dy, kernel, stride, pad)
    if x.device.type == "cpu":
        return maxpool_bwd_reference(x, dy, kernel, stride, pad)
    lib = _kernels.library("maxpool_bwd")
    n, h, w, c = x.shape
    idx = torch.empty(dy.shape, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    _kernels.launch(lib, lib.mxt_maxpool_bwd, x, dy, idx, dx, n, h, w, c,
                    dy.shape[1], dy.shape[2], kernel[0], kernel[1], stride[0],
                    stride[1], pad[0], pad[1], _DTYPE_CODES[x.dtype])
    maxpool_bwd.launches += 1
    return dx


maxpool_bwd.launches = 0
