"""Convolution backward-filter (dW) of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/pallas_conv.py``.  Layouts: data NHWC,
weight OHWI, dilation (dh, dw), ``groups`` G:

    dW[o, r, s, i] = sum_{n,y,x} Xp[n, y*sy + r*dh, x*sx + s*dw, g*I/G + i]
                     * dY[n, y, x, o],   g = o // (O/G), i < I/G

with ``Xp`` the input zero-padded by ``pad`` on both sides; dW is (O, KH,
KW, I/G).  The JAX package sends a dilated or grouped convolution's dW to
XLA (``ops/nn.py:79-80``, ``pallas_conv.py:57``); here they run the same
kernels as every other convolution, a tap reading ``x`` ``r*dh`` rows and
``s*dw`` columns from the window's corner, each group one more slice of
the grid reading its channels of ``x`` and ``dy`` (a depthwise
convolution, I/G = 1, included).

- :func:`conv_dw_reference` is the plain version: one float32 ``einsum``
  per tap over strided slices of the padded input, the JAX formula
  written out.
- :func:`conv_dw_pertap` (K1a) and :func:`conv_dw_im2col` (K1b) launch
  the hand-written Hopper kernels of ``csrc/conv_dw.cu`` on CUDA tensors
  (which replace the Pallas ``_dw_kernel_pertap`` and
  ``_dw_kernel_im2col``) and take the plain version on CPU tensors.  On
  the card they never fall back: a launch that fails raises.  Each counts
  its launches in ``.launches``.
- :func:`conv_dw` picks the formulation by the JAX package's rule
  (:func:`formulation`: im2col below 128 input channels of a group) and
  runs it.
- :func:`launch_plan` says, from the shapes alone, what a launch runs:
  the tensor-core kernel, bf16 and float16 on 16-bit ``wgmma`` (16-byte
  or register-staged loads of x and dy) and float32 by 3xTF32 on tf32
  ``wgmma`` (16-byte or 4-byte loads; the S operand's rows, 128 or, when
  O <= 64, O padded to 16, 24, 32 or 64), with the split-K partition
  (:func:`split_plan`) and the workspace.

Every result is float32 (O, KH, KW, I/G); the caller casts it to the
weight's dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _kernels
from ..base import MXNetError

__all__ = ["conv_dw", "conv_dw_reference", "conv_dw_pertap",
           "conv_dw_im2col", "formulation", "split_plan", "launch_plan",
           "LaunchPlan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMS = 132              # streaming multiprocessors of an H100
# bf16 and float16 on 16-bit wgmma: 128 (o; 64 when O <= 64) x 128 (rows)
# tiles over stages of 64 positions, one resident block per SM (its ring
# takes 161 KB of shared memory)
TC_TILE_ROWS, TC_STAGE = 128, 64
# float32 by 3xTF32 on tf32 wgmma: 128 rows of the register operand (o
# when O > 64, else rows m) by 128 or the padded O, stages of 32
# positions, one resident block per SM (a ring of up to 197 KB)
TF32_STAGE = 32
TF32_NARROW_O = (16, 24, 32, 64)
_MIN_CHUNK_STAGES = 4   # fewest stages a split sums
_TC_MAX_WAVES = 8       # the most waves of blocks a split plan may ask
_BLOCK_STAGES = 8       # a block's own cost (pipeline fill, epilogue), in
                        # stages


class LaunchPlan(NamedTuple):
    """What one dW launch runs: the C entry point, the kernel (always
    ``"tensor-core"``), its route (``"wgmma"``: bf16 and float16 products
    on 16-bit wgmma; ``"tf32x3"``: float32 as three tf32 products each),
    how it loads x and dy (``"16-byte"``; else ``"register-staged"`` for
    16-bit types, ``"4-byte"`` for float32), the output channels of its
    tile (16-bit: 128, or 64 when O <= 64; float32: 128, or O padded to
    16, 24, 32 or 64 when O <= 64), the split-K partition (``splits``
    chunks of ``chunk`` positions, whole stages, the last one shorter) and
    the float32 workspace it needs, in elements (0: dW written
    directly)."""
    entry: str
    kernel: str
    route: str
    x_loads: str
    dy_loads: str
    tile_o: int
    splits: int
    chunk: int
    ws_elems: int

    @property
    def variant(self):
        """The C entry's variant argument: bit 0 dy and bit 1 x by
        16-byte loads; then ``"wgmma"``: bit 2 tiles of 64 output
        channels; ``"tf32x3"``: bits 2-6 the tile's output channels / 8."""
        vec = (self.dy_loads == "16-byte") | (self.x_loads == "16-byte") << 1
        if self.route == "tf32x3":
            return vec | (self.tile_o // 8) << 2
        return vec | (self.tile_o == 64) << 2


def formulation(in_channels):
    """``"im2col"`` below 128 input channels (of a group), else
    ``"pertap"`` (``pallas_conv.py:178-181``)."""
    return "im2col" if in_channels < 128 else "pertap"


def _tiles(form, kernel, in_channels, out_channels, tile_rows, tile_o,
           groups=1):
    kh, kw = kernel
    rows = kh * kw * in_channels if form == "im2col" else in_channels
    tiles = -(-rows // tile_rows) * -(-out_channels // tile_o) * groups
    return tiles * (kh * kw if form == "pertap" else 1)


def split_plan(form, kernel, in_channels, out_channels, positions,
               dtype=torch.float32, groups=1):
    """(splits, chunk) of the split-K partition: the reduction over
    ``positions`` = N*OH*OW is cut into ``splits`` chunks of ``chunk``
    positions (the last one shorter).  ``in_channels`` and
    ``out_channels`` are a group's; the tiles of all ``groups`` count.

    Chunks are whole stages (64 positions for bf16 and float16, 32 for
    float32), at least four, and the split count is the one, up to eight
    waves of blocks (one resident block per SM), that the cost model waves
    x (stages a chunk + 8) puts lowest, so that the blocks fill the 132 SMs
    in whole waves."""
    stage = TF32_STAGE if dtype == torch.float32 else TC_STAGE
    tiles = _tiles(form, kernel, in_channels, out_channels, TC_TILE_ROWS,
                   _tile_o(out_channels, dtype), groups)
    stages = -(-positions // stage)
    most = max(1, min(-(-_TC_MAX_WAVES * _SMS // tiles),
                      stages // _MIN_CHUNK_STAGES))
    best = None
    for cut in range(1, most + 1):
        per = -(-stages // cut)          # stages a chunk
        splits = -(-stages // per)
        cost = -(-tiles * splits // _SMS) * (per + _BLOCK_STAGES)
        if best is None or cost < best[0]:
            best = (cost, splits, per * stage)
    return best[1], best[2]


def _tile_o(out_channels, dtype):
    """Output channels of a tile.  bf16 and float16: 64 when O <= 64 (the
    warpgroups then split the rows), else 128.  float32: O padded to 16,
    24, 32 or 64 when O <= 64 (dY then lies on wgmma's N), else 128."""
    if dtype != torch.float32:
        return 64 if out_channels <= 64 else 128
    return next((n for n in TF32_NARROW_O if out_channels <= n), 128)


@functools.lru_cache(maxsize=None)
def launch_plan(form, kernel, stride, pad, x_shape, o, dtype,
                dilate=(1, 1), groups=1):
    """The :class:`LaunchPlan` of dW by ``form`` for an NHWC ``x_shape``,
    ``kernel``, ``stride``, ``pad``, ``dilate``, ``o`` output channels
    and ``groups`` in ``dtype`` (float32, bfloat16 or float16): a pure
    function of the shapes.  The loads, the tile and the split follow a
    group's widths I/G and O/G: a group's channel slice keeps the 16-byte
    loads only where its width is a whole number of them, as its channel
    offset then keeps them aligned."""
    n, h, w, ci = x_shape
    kh, kw = kernel
    cg, og = ci // groups, o // groups
    positions = (n * _out_size(h, kh, stride[0], pad[0], dilate[0])
                 * _out_size(w, kw, stride[1], pad[1], dilate[1]))
    splits, chunk = split_plan(form, kernel, cg, og, positions, dtype,
                               groups)
    dw_elems = o * kh * kw * cg
    f32 = dtype == torch.float32
    lanes, other = (4, "4-byte") if f32 else (8, "register-staged")
    return LaunchPlan("mxt_conv_dw_" + form, "tensor-core",
                      "tf32x3" if f32 else "wgmma",
                      "16-byte" if cg % lanes == 0 else other,
                      "16-byte" if og % lanes == 0 else other,
                      _tile_o(og, dtype), splits, chunk,
                      splits * dw_elems if splits > 1 else 0)


def _out_size(size, k, s, p, d=1):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _check(x, dy, kernel, stride, pad, dilate, groups):
    if x.dim() != 4 or dy.dim() != 4:
        raise MXNetError("conv_dw takes NHWC x and dy")
    if groups < 1 or x.shape[3] % groups or dy.shape[3] % groups:
        raise MXNetError("conv_dw: %d groups do not divide I = %d and O = "
                         "%d" % (groups, x.shape[3], dy.shape[3]))
    n, h, w, _ = x.shape
    kh, kw = kernel
    sy, sx = stride
    py, px = pad
    dh, dw = dilate
    want = (n, _out_size(h, kh, sy, py, dh), _out_size(w, kw, sx, px, dw))
    if min(kh, kw, sy, sx, dh, dw) < 1 or min(py, px) < 0 \
            or tuple(dy.shape[:3]) != want:
        raise MXNetError("conv_dw: dy %s does not match x %s, kernel %s, "
                         "stride %s, pad %s, dilate %s"
                         % (tuple(dy.shape), tuple(x.shape), kernel, stride,
                            pad, dilate))
    if x.device != dy.device:
        raise MXNetError("x and dy lie on different devices")
    if x.dtype != dy.dtype or x.dtype not in _DTYPE_CODES:
        raise MXNetError("conv_dw takes x and dy of one dtype, float32, "
                         "bfloat16 or float16 (got %s, %s)"
                         % (x.dtype, dy.dtype))
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise MXNetError("conv_dw takes contiguous NHWC x and dy")
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError("conv_dw runs on CPU or CUDA tensors, not %s"
                         % x.device)


def conv_dw_reference(x, dy, kernel, stride=(1, 1), pad=(0, 0),
                      dilate=(1, 1), groups=1):
    """Plain dW: float32 (O, KH, KW, I/G), one einsum per tap and group."""
    kh, kw = kernel
    sy, sx = stride
    py, px = pad
    dh, dw_ = dilate
    oh, ow = dy.shape[1], dy.shape[2]
    cg, og = x.shape[3] // groups, dy.shape[3] // groups
    xp = F.pad(x.float(), (0, 0, px, px, py, py))
    dyf = dy.float()
    dw = torch.empty((dy.shape[3], kh, kw, cg), dtype=torch.float32,
                     device=x.device)
    for g in range(groups):
        dyg = dyf[..., g * og:(g + 1) * og]
        for r in range(kh):
            for s in range(kw):
                y0, x0 = r * dh, s * dw_
                xs = xp[:, y0:y0 + sy * (oh - 1) + 1:sy,
                        x0:x0 + sx * (ow - 1) + 1:sx, g * cg:(g + 1) * cg]
                dw[g * og:(g + 1) * og, r, s, :] = torch.einsum(
                    "nyxi,nyxo->oi", xs, dyg)
    return dw


def _aligned(t):
    """``t`` itself if its data lies on a 16-byte boundary, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run(form, x, dy, kernel, stride, pad, dilate, groups):
    _check(x, dy, kernel, stride, pad, dilate, groups)
    if x.device.type == "cpu":
        return conv_dw_reference(x, dy, kernel, stride, pad, dilate, groups)
    lib = _kernels.library("conv_dw")
    n, h, w, ci = x.shape
    _, oh, ow, co = dy.shape
    kh, kw = kernel
    plan = launch_plan(form, tuple(kernel), tuple(stride), tuple(pad),
                       tuple(x.shape), co, x.dtype, tuple(dilate), groups)
    if plan.dy_loads == "16-byte":
        dy = _aligned(dy)
    if plan.x_loads == "16-byte":
        x = _aligned(x)
    ws = torch.empty(plan.ws_elems, dtype=torch.float32, device=x.device)
    dw = torch.empty((co, kh, kw, ci // groups), dtype=torch.float32,
                     device=x.device)
    _kernels.launch(lib, getattr(lib, plan.entry), x, dy, ws, dw, n, h, w, ci,
                    oh, ow, co, kh, kw, stride[0], stride[1], pad[0], pad[1],
                    dilate[0], dilate[1], groups, plan.splits, plan.chunk,
                    _DTYPE_CODES[x.dtype], plan.variant)
    return dw


def conv_dw_pertap(x, dy, kernel, stride=(1, 1), pad=(0, 0),
                   dilate=(1, 1), groups=1):
    """dW by K1a (a block owns one tap of a group) on CUDA tensors, the
    plain version on CPU tensors."""
    dw = _run("pertap", x, dy, kernel, stride, pad, dilate, groups)
    if x.device.type == "cuda":
        conv_dw_pertap.launches += 1
    return dw


def conv_dw_im2col(x, dy, kernel, stride=(1, 1), pad=(0, 0),
                   dilate=(1, 1), groups=1):
    """dW by K1b (a block's rows are a group's flattened (r, s, i)) on
    CUDA tensors, the plain version on CPU tensors."""
    dw = _run("im2col", x, dy, kernel, stride, pad, dilate, groups)
    if x.device.type == "cuda":
        conv_dw_im2col.launches += 1
    return dw


def conv_dw(x, dy, kernel, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
            groups=1):
    """dW of an NHWC/OHWI convolution of ``groups`` groups: x (N, H, W,
    I) and dy (N, OH, OW, O), contiguous, one dtype (float32, bfloat16 or
    float16).  Returns float32 (O, KH, KW, I/G) through K1b when I/G <
    128, else K1a."""
    run = conv_dw_im2col if formulation(x.shape[-1] // groups) == "im2col" \
        else conv_dw_pertap
    return run(x, dy, tuple(kernel), tuple(stride), tuple(pad),
               tuple(dilate), int(groups))


conv_dw_pertap.launches = 0
conv_dw_im2col.launches = 0
