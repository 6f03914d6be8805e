"""Fused multi-head attention of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/attention.py``.  Layout: (batch, heads,
seq, head_dim) throughout.

- :func:`mha_reference` is the plain version: einsum and softmax in
  float32, with the JAX package's mask value.
- :func:`flash_attention` is the wrapper of the hand-written Hopper
  kernel ``csrc/flash_attn_fwd.cu`` (which replaces the Pallas
  ``_fwd_kernel``).  On CPU tensors it takes the plain version; on CUDA
  tensors it launches the kernel and raises if the launch fails.  It never
  falls back.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["mha_reference", "flash_attention", "HEAD_DIMS"]

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(q, sm_scale):
    return (1.0 / math.sqrt(q.shape[-1])) if sm_scale is None else sm_scale


def mha_reference(q, k, v, causal=False, sm_scale=None, return_lse=False):
    """Unfused attention ``softmax(q k^T * scale) v`` in float32.

    As in the JAX package: the scores are float32 whatever the input
    type, the causal mask (top-left aligned, ``col > row``) writes
    ``-1e30``, the probabilities are cast to ``v``'s type before the
    second product, and the result is in ``q``'s type.  With
    ``return_lse`` it also returns the rows' log-sum-exp, (B, H, Sq)
    float32, as the kernel does."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * _scale(q, sm_scale)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=s.device).unsqueeze(1)
        col = torch.arange(sk, device=s.device).unsqueeze(0)
        s = s.masked_fill(col > row, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention takes (B, H, S, D) tensors")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise MXNetError("flash_attention shapes disagree: q %s, k %s, v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if d not in HEAD_DIMS:
        raise MXNetError("flash_attention supports head_dim %s, not %d"
                         % (HEAD_DIMS, d))
    if sq == 0 or k.shape[2] == 0:
        raise MXNetError("flash_attention needs non-empty sequences")
    if not (q.device == k.device == v.device):
        raise MXNetError("q, k and v lie on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise MXNetError("flash_attention takes q, k, v of one dtype, "
                         "float32 or bfloat16 (got %s, %s, %s)"
                         % (q.dtype, k.dtype, v.dtype))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention takes contiguous q, k, v")


def flash_attention(q, k, v, causal=False, sm_scale=None, return_lse=False):
    """Fused attention over contiguous (B, H, S, D) tensors of one dtype
    (float32 or bfloat16), D in :data:`HEAD_DIMS`, any sequence lengths.

    Returns O in ``q``'s dtype, and with ``return_lse`` also the rows'
    log-sum-exp, (B, H, Sq) float32.  ``sm_scale`` defaults to
    ``1/sqrt(D)``."""
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=scale,
                             return_lse=return_lse)
    if q.device.type != "cuda":
        raise MXNetError("flash_attention runs on CPU or CUDA tensors, "
                         "not %s" % q.device)
    from .. import _kernels

    lib = _kernels.library("flash_attn_fwd")
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, sq, k.shape[2], d, float(scale),
            int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise MXNetError("flash-attention kernel launch failed: %s"
                         % lib.mxt_error_string(err).decode())
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
