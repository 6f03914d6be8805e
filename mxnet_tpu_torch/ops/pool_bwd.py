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
  ``maxpool_bwd.launches``.  One launch a call, no scratch: the block
  that takes a tile of dx computes the argmax of every window over it.
- :func:`launch_plan` says, from the shapes alone, how a launch tiles dx
  (tile rows, columns and channels, and the shared memory it stages),
  and :func:`tile_geometry` where one tile, its windows and its x halo
  lie: the kernel's index arithmetic, written out for the host.

Both sum the ``dy`` a pixel receives in float32, in window order (``oy``,
then ``ox``, ascending), and round once to ``dy``'s dtype, so on the card
the kernel equals the plain version bit for bit.  (The JAX kernel
accumulates in ``dy``'s dtype.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _kernels
from ..base import MXNetError

__all__ = ["maxpool_bwd", "maxpool_bwd_reference", "launch_plan",
           "tile_geometry", "LaunchPlan", "SMEM_BUDGET"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_TAPS = 255  # the kernel keeps each window's argmax tap in one byte
# what a block may stage (x's halo, the windows' dy and their argmax):
# with 72 KB three blocks share an SM of the H100
SMEM_BUDGET = 72 * 1024
_TILE = 16          # dx rows and columns of a block, before the budget
_CHUNK_BYTES = 128  # channels of a block: 128 bytes of one pixel


class LaunchPlan(NamedTuple):
    """How one K2 launch tiles dx.  ``access``: ``"16-byte"`` (``vec``
    channels a load or store: 8 of bf16 or float16, 4 of float32) or
    ``"scalar"`` (``vec`` 1, where C or a pointer's alignment does not
    allow 16 bytes).  A tile is ``tile_h`` x ``tile_w`` pixels x
    ``tile_c`` channels of one image; ``tiles_h``, ``tiles_w`` and
    ``chunks`` tile H, W and C.  ``windows_h`` x ``windows_w`` is the
    most windows that cover a tile, ``halo_h`` x ``halo_w`` the most x
    pixels they read.  The block that takes a tile stages that halo of x,
    the windows' dy at ``dy_offset`` and their argmax array (16 bits a
    window and channel) at ``arg_offset``: ``smem_bytes`` of shared
    memory in all."""
    access: str
    vec: int
    tile_h: int
    tile_w: int
    tile_c: int
    tiles_h: int
    tiles_w: int
    chunks: int
    windows_h: int
    windows_w: int
    halo_h: int
    halo_w: int
    dy_offset: int
    arg_offset: int
    smem_bytes: int

    def tiles(self, n):
        """Tiles, and so thread blocks, of a launch over ``n`` images."""
        return n * self.tiles_h * self.tiles_w * self.chunks


def _align16(b):
    return -(-b // 16) * 16


def _staging(tile_h, tile_w, tile_c, kernel, stride, out_hw, esize):
    """(windows_h, windows_w, halo_h, halo_w, dy_offset, arg_offset,
    smem_bytes) of a tile: the most windows over ``tile_h`` rows
    (``(tile_h + kh - 2) // sy + 1``, at most OH), the x rows they read,
    and the shared memory of x's halo, the windows' dy and their argmax
    array (2 bytes a window and channel), each region 16-byte aligned
    (the same sums as the C launcher's)."""
    wy = min((tile_h + kernel[0] - 2) // stride[0] + 1, out_hw[0])
    wx = min((tile_w + kernel[1] - 2) // stride[1] + 1, out_hw[1])
    hh = (wy - 1) * stride[0] + kernel[0]
    hw = (wx - 1) * stride[1] + kernel[1]
    dy_off = _align16(hh * hw * tile_c * esize)
    arg_off = dy_off + _align16(wy * wx * tile_c * esize)
    return (wy, wx, hh, hw, dy_off, arg_off,
            _align16(arg_off + 2 * wy * wx * tile_c))


@functools.lru_cache(maxsize=None)
def launch_plan(x_shape, dy_shape, kernel, stride, dtype, aligned=True):
    """The :class:`LaunchPlan` of K2 for NHWC ``x_shape`` and
    ``dy_shape``, ``kernel`` and ``stride`` in ``dtype``: a pure function
    of the shapes (``aligned``: x, dy and dx lie on 16-byte boundaries).

    Tiles start at 16 x 16 pixels x 128 bytes of channels; while the
    staging exceeds :data:`SMEM_BUDGET`, the larger of the tile's height
    and width is halved, then its channels (large windows, stride 1)."""
    n, h, w, c = x_shape
    out_hw = tuple(dy_shape[1:3])
    esize = torch.finfo(dtype).bits // 8
    vec = 16 // esize
    if not aligned or c % vec:
        vec = 1
    tile_h, tile_w = min(_TILE, h), min(_TILE, w)
    tile_c = min(c, _CHUNK_BYTES // esize)
    while True:
        st = _staging(tile_h, tile_w, tile_c, kernel, stride, out_hw, esize)
        if st[-1] <= SMEM_BUDGET:
            break
        if max(tile_h, tile_w) > 1:
            if tile_h >= tile_w:
                tile_h = -(-tile_h // 2)
            else:
                tile_w = -(-tile_w // 2)
        elif tile_c > vec:
            tile_c = max(vec, tile_c // 2 // vec * vec)
        else:  # pragma: no cover - 255 taps stage at most 16 KB
            raise MXNetError("maxpool_bwd: no tile of %s fits %d bytes"
                             % (x_shape, SMEM_BUDGET))
    return LaunchPlan("16-byte" if vec > 1 else "scalar", vec, tile_h,
                      tile_w, tile_c, -(-h // tile_h), -(-w // tile_w),
                      -(-c // tile_c), *st)


def _first_window(y, k, s):
    """The first window (along one axis) that covers padded position
    ``y``."""
    return 0 if y - k + 1 <= 0 else (y - k + s) // s


def tile_geometry(plan, x_shape, dy_shape, kernel, stride, pad, tile):
    """Where tile ``tile`` of a launch by ``plan`` lies, as the kernel
    computes it: a dict of half-open ranges, ``rows``, ``cols`` and
    ``channels`` of dx in image ``n``; ``windows_h`` and ``windows_w`` of
    the windows that cover the tile (empty when none does); ``halo_rows``
    and ``halo_cols`` of the x they read, in image coordinates (outside
    the image: padding, read as -inf).  Tiles run channel chunk fastest,
    then tile column, tile row, image."""
    n, h, w, c = x_shape
    oh, ow = dy_shape[1], dy_shape[2]
    b = tile
    chunk, b = b % plan.chunks, b // plan.chunks
    tcol, b = b % plan.tiles_w, b // plan.tiles_w
    trow, img = b % plan.tiles_h, b // plan.tiles_h
    h0, w0, c0 = trow * plan.tile_h, tcol * plan.tile_w, chunk * plan.tile_c
    h1, w1 = min(h0 + plan.tile_h, h), min(w0 + plan.tile_w, w)
    oy0 = _first_window(h0 + pad[0], kernel[0], stride[0])
    oy1 = min((h1 - 1 + pad[0]) // stride[0], oh - 1) + 1
    ox0 = _first_window(w0 + pad[1], kernel[1], stride[1])
    ox1 = min((w1 - 1 + pad[1]) // stride[1], ow - 1) + 1
    y0, x0 = oy0 * stride[0] - pad[0], ox0 * stride[1] - pad[1]
    hh = (oy1 - oy0 - 1) * stride[0] + kernel[0] if oy1 > oy0 else 0
    hw = (ox1 - ox0 - 1) * stride[1] + kernel[1] if ox1 > ox0 else 0
    return {"n": img, "rows": (h0, h1), "cols": (w0, w1),
            "channels": (c0, min(c0 + plan.tile_c, c)),
            "windows_h": (oy0, max(oy1, oy0)),
            "windows_w": (ox0, max(ox1, ox0)),
            "halo_rows": (y0, y0 + hh), "halo_cols": (x0, x0 + hw)}


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
        raise MXNetError("maxpool_bwd takes x and dy of one dtype, float32, "
                         "bfloat16 or float16 (got %s, %s)"
                         % (x.dtype, dy.dtype))
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise MXNetError("maxpool_bwd takes contiguous NHWC x and dy")
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError("maxpool_bwd runs on CPU or CUDA tensors, not %s"
                         % x.device)


def maxpool_bwd(x, dy, kernel, stride, pad=(0, 0)):
    """dX of an NHWC max pool: x (N, H, W, C) the forward's input, dy
    (N, OH, OW, C) the output's gradient, contiguous and of one dtype
    (float32, bfloat16 or float16); returns (N, H, W, C) in that dtype."""
    kernel, stride, pad = tuple(kernel), tuple(stride), tuple(pad)
    _check(x, dy, kernel, stride, pad)
    if x.device.type == "cpu":
        return maxpool_bwd_reference(x, dy, kernel, stride, pad)
    lib = _kernels.library("maxpool_bwd")
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
    plan = launch_plan(tuple(x.shape), tuple(dy.shape), kernel, stride,
                       x.dtype, aligned)
    _kernels.launch(lib, lib.mxt_maxpool_bwd, x, dy, dx, n, h, w, c,
                    dy.shape[1], dy.shape[2], kernel[0], kernel[1], stride[0],
                    stride[1], pad[0], pad[1], plan.tile_h, plan.tile_w,
                    plan.tile_c, plan.vec, _DTYPE_CODES[x.dtype])
    maxpool_bwd.launches += 1
    return dx


maxpool_bwd.launches = 0
