"""Convolution backward-filter (dW) of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/pallas_conv.py``.  Layouts: data NHWC,
weight OHWI, groups 1, dilation 1:

    dW[o, r, s, i] = sum_{n,y,x} Xp[n, y*sy + r, x*sx + s, i] * dY[n, y, x, o]

with ``Xp`` the input zero-padded by ``pad`` on both sides.

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
  (:func:`formulation`: im2col below 128 input channels) and runs it.

Every result is float32 (O, KH, KW, I); the caller casts it to the
weight's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _kernels
from ..base import MXNetError

__all__ = ["conv_dw", "conv_dw_reference", "conv_dw_pertap",
           "conv_dw_im2col", "formulation", "split_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64              # rows and output channels of a kernel block
_TARGET_BLOCKS = 4 * 132  # blocks in flight: four per SM of an H100
_MIN_CHUNK = 256        # fewest reduction positions a split sums


def formulation(in_channels):
    """``"im2col"`` below 128 input channels, else ``"pertap"``
    (``pallas_conv.py:178-181``)."""
    return "im2col" if in_channels < 128 else "pertap"


def split_plan(form, kernel, in_channels, out_channels, positions):
    """(splits, chunk) of the split-K partition: the reduction over
    ``positions`` = N*OH*OW is cut into ``splits`` chunks of ``chunk``
    positions (the last one shorter), enough that the tiles of
    ``form`` times the splits put about :data:`_TARGET_BLOCKS` blocks in
    flight, and no chunk shorter than :data:`_MIN_CHUNK` positions."""
    kh, kw = kernel
    rows = kh * kw * in_channels if form == "im2col" else in_channels
    tiles = -(-rows // _TILE) * -(-out_channels // _TILE)
    if form == "pertap":
        tiles *= kh * kw
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles),
                        -(-positions // _MIN_CHUNK)))
    chunk = -(-positions // splits)
    return -(-positions // chunk), chunk


def _out_size(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def _check(x, dy, kernel, stride, pad):
    if x.dim() != 4 or dy.dim() != 4:
        raise MXNetError("conv_dw takes NHWC x and dy")
    n, h, w, _ = x.shape
    kh, kw = kernel
    sy, sx = stride
    py, px = pad
    want = (n, _out_size(h, kh, sy, py), _out_size(w, kw, sx, px))
    if min(kh, kw, sy, sx) < 1 or min(py, px) < 0 \
            or tuple(dy.shape[:3]) != want:
        raise MXNetError("conv_dw: dy %s does not match x %s, kernel %s, "
                         "stride %s, pad %s" % (tuple(dy.shape),
                                                tuple(x.shape), kernel,
                                                stride, pad))
    if x.device != dy.device:
        raise MXNetError("x and dy lie on different devices")
    if x.dtype != dy.dtype or x.dtype not in _DTYPE_CODES:
        raise MXNetError("conv_dw takes x and dy of one dtype, float32 or "
                         "bfloat16 (got %s, %s)" % (x.dtype, dy.dtype))
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise MXNetError("conv_dw takes contiguous NHWC x and dy")
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError("conv_dw runs on CPU or CUDA tensors, not %s"
                         % x.device)


def conv_dw_reference(x, dy, kernel, stride=(1, 1), pad=(0, 0)):
    """Plain dW: float32 (O, KH, KW, I), one einsum per tap."""
    kh, kw = kernel
    sy, sx = stride
    py, px = pad
    oh, ow = dy.shape[1], dy.shape[2]
    xp = F.pad(x.float(), (0, 0, px, px, py, py))
    dyf = dy.float()
    dw = torch.empty((dy.shape[3], kh, kw, x.shape[3]), dtype=torch.float32,
                     device=x.device)
    for r in range(kh):
        for s in range(kw):
            xs = xp[:, r:r + sy * (oh - 1) + 1:sy, s:s + sx * (ow - 1) + 1:sx]
            dw[:, r, s, :] = torch.einsum("nyxi,nyxo->oi", xs, dyf)
    return dw


def _run(form, x, dy, kernel, stride, pad):
    _check(x, dy, kernel, stride, pad)
    if x.device.type == "cpu":
        return conv_dw_reference(x, dy, kernel, stride, pad)
    lib = _kernels.library("conv_dw")
    n, h, w, ci = x.shape
    _, oh, ow, co = dy.shape
    kh, kw = kernel
    splits, chunk = split_plan(form, kernel, ci, co, n * oh * ow)
    ws = torch.empty(splits * co * kh * kw * ci, dtype=torch.float32,
                     device=x.device)
    dw = torch.empty((co, kh, kw, ci), dtype=torch.float32, device=x.device)
    fn = lib.mxt_conv_dw_im2col if form == "im2col" else lib.mxt_conv_dw_pertap
    _kernels.launch(lib, fn, x, dy, ws, dw, n, h, w, ci, oh, ow, co, kh, kw,
                    stride[0], stride[1], pad[0], pad[1], splits, chunk,
                    _DTYPE_CODES[x.dtype])
    return dw


def conv_dw_pertap(x, dy, kernel, stride=(1, 1), pad=(0, 0)):
    """dW by K1a (a block owns one tap) on CUDA tensors, the plain
    version on CPU tensors."""
    dw = _run("pertap", x, dy, kernel, stride, pad)
    if x.device.type == "cuda":
        conv_dw_pertap.launches += 1
    return dw


def conv_dw_im2col(x, dy, kernel, stride=(1, 1), pad=(0, 0)):
    """dW by K1b (a block's rows are the flattened (r, s, i)) on CUDA
    tensors, the plain version on CPU tensors."""
    dw = _run("im2col", x, dy, kernel, stride, pad)
    if x.device.type == "cuda":
        conv_dw_im2col.launches += 1
    return dw


def conv_dw(x, dy, kernel, stride=(1, 1), pad=(0, 0)):
    """dW of an NHWC/OHWI convolution: x (N, H, W, I) and dy (N, OH, OW,
    O), contiguous, one dtype (float32 or bfloat16).  Returns float32 (O,
    KH, KW, I) through K1b when I < 128, else K1a."""
    run = conv_dw_im2col if formulation(x.shape[-1]) == "im2col" \
        else conv_dw_pertap
    return run(x, dy, tuple(kernel), tuple(stride), tuple(pad))


conv_dw_pertap.launches = 0
conv_dw_im2col.launches = 0
