"""Fused multi-head attention of the PyTorch port.

Counterpart of ``mxnet_tpu/ops/attention.py``.  Layout: (batch, heads,
seq, head_dim) throughout.

- :func:`mha_reference` is the plain version of the forward: einsum and
  softmax in float32, with the JAX package's mask value.
  :func:`flash_attention_bwd_reference` is the plain version of the
  backward, with ``_bwd_pallas``'s arithmetic.
- :func:`flash_attention` is differentiable on both devices through one
  ``torch.autograd.Function``.  On CUDA tensors its forward launches the
  hand-written Hopper kernel ``csrc/flash_attn_fwd.cu`` (which replaces the
  Pallas ``_fwd_kernel``) and its backward the kernels of
  ``csrc/flash_attn_bwd.cu`` (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``);
  on CPU tensors it takes the plain versions.  On the card it never falls
  back: a launch that fails raises.
- The kernel wrappers count their launches: ``flash_attention.launches``
  (forward), ``flash_attention_bwd_dq.launches`` and
  ``flash_attention_bwd_dkv.launches``.
"""

from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["mha_reference", "flash_attention", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "HEAD_DIMS"]

_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(q, sm_scale):
    return (1.0 / math.sqrt(q.shape[-1])) if sm_scale is None else sm_scale


def _scores(q, k, causal, sm_scale):
    """float32 ``q k^T * scale``, ``-1e30`` where ``col > row`` if causal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=s.device).unsqueeze(1)
        col = torch.arange(sk, device=s.device).unsqueeze(0)
        s = s.masked_fill(col > row, _NEG_INF)
    return s


def mha_reference(q, k, v, causal=False, sm_scale=None, return_lse=False):
    """Unfused attention ``softmax(q k^T * scale) v`` in float32.

    As in the JAX package: the scores are float32 whatever the input
    type, the causal mask (top-left aligned, ``col > row``) writes
    ``-1e30``, the probabilities are cast to ``v``'s type before the
    second product, and the result is in ``q``'s type.  With
    ``return_lse`` it also returns the rows' log-sum-exp, (B, H, Sq)
    float32, as the kernel does."""
    s = _scores(q, k, causal, _scale(q, sm_scale))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _bwd_delta(o, do):
    """``rowsum(dO * O)`` in float32, (B, H, Sq): the term both backward
    kernels subtract from ``dO V^T``."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_p_ds(q, k, v, lse, delta, do, causal, sm_scale):
    """float32 ``p = exp(s - lse)`` and ``ds = p * (dO V^T - delta) *
    scale``, the scores recomputed from ``q`` and ``k``."""
    s = _scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.unsqueeze(-1)) * sm_scale


def _bwd_dq_plain(ds, k, dtype):
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(dtype)


def _bwd_dkv_plain(p, ds, q, do, dtype):
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(dtype), dv.to(dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  sm_scale=None):
    """Plain backward of attention: (dq, dk, dv) given the forward's
    output ``o`` and log-sum-exp ``lse`` and the output's gradient ``do``.

    The arithmetic of the JAX package's ``_bwd_pallas``: ``delta =
    rowsum(dO * O)``, ``p = exp(s - lse)`` with the scores recomputed (and
    masked to ``-1e30`` when causal), ``ds = p * (dO V^T - delta) *
    scale``; ``dq = ds K``, ``dk = ds^T Q``, ``dv = p^T dO``; all in
    float32, each gradient returned in its input's dtype."""
    p, ds = _bwd_p_ds(q, k, v, lse, _bwd_delta(o, do), do, causal,
                      _scale(q, sm_scale))
    return (_bwd_dq_plain(ds, k, q.dtype),) + _bwd_dkv_plain(p, ds, q, do,
                                                            k.dtype)


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
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError("flash_attention runs on CPU or CUDA tensors, "
                         "not %s" % q.device)


def _check_bwd(q, k, do, lse, delta):
    """The backward's extra operands: ``do`` like ``q``; ``lse`` and
    ``delta`` contiguous (B, H, Sq) float32 on ``q``'s device."""
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise MXNetError("the output gradient must be a contiguous tensor "
                         "of q's shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise MXNetError("%s must be a contiguous (B, H, Sq) float32 "
                             "tensor" % name)
    if not (do.device == lse.device == delta.device == q.device == k.device):
        raise MXNetError("the backward's operands lie on different devices")


def _launch(lib, fn, *args):
    """Call a kernel library's launcher on the current stream of the
    first tensor's device; raise if the launch was refused."""
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise MXNetError("%s launch failed: %s"
                         % (fn.__name__, lib.mxt_error_string(err).decode()))


def _fwd(q, k, v, causal, scale):
    """(out, lse): the kernel on CUDA tensors, the plain version on CPU."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=scale,
                             return_lse=True)
    from .. import _kernels

    lib = _kernels.library("flash_attn_fwd")
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch(lib, lib.mxt_flash_attn_fwd, q, k, v, out, lse, b * h, sq,
            k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype])
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           sm_scale=None):
    """dq of attention from the forward's ``lse`` and ``delta =
    rowsum(dO * O)`` (both (B, H, Sq) float32): kernel K4a on CUDA
    tensors, the plain version on CPU tensors."""
    _check(q, k, v)
    _check_bwd(q, k, do, lse, delta)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        _, ds = _bwd_p_ds(q, k, v, lse, delta, do, causal, scale)
        return _bwd_dq_plain(ds, k, q.dtype)
    from .. import _kernels

    lib = _kernels.library("flash_attn_bwd")
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    _launch(lib, lib.mxt_flash_attn_bwd_dq, q, k, v, do, lse, delta, dq,
            b * h, sq, k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype])
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            sm_scale=None):
    """(dk, dv) of attention from ``lse`` and ``delta``: kernel K4b on
    CUDA tensors, the plain version on CPU tensors."""
    _check(q, k, v)
    _check_bwd(q, k, do, lse, delta)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        p, ds = _bwd_p_ds(q, k, v, lse, delta, do, causal, scale)
        return _bwd_dkv_plain(p, ds, q, do, k.dtype)
    from .. import _kernels

    lib = _kernels.library("flash_attn_bwd")
    b, h, sq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(lib, lib.mxt_flash_attn_bwd_dkv, q, k, v, do, lse, delta, dk, dv,
            b * h, sq, k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype])
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with its backward, on both devices through the same
    wrappers, which launch the CUDA kernels on the card and take the plain
    versions on the CPU.  Saves q, k, v, o and lse only when a gradient
    can be asked for (never under ``torch.inference_mode()``); lse is not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _fwd(q, k, v, causal, scale)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # the output is transposed right after the call, so its gradient
        # arrives as a permuted view
        do = do.contiguous()
        delta = _bwd_delta(o, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None, return_lse=False):
    """Fused attention over contiguous (B, H, S, D) tensors of one dtype
    (float32 or bfloat16), D in :data:`HEAD_DIMS`, any sequence lengths.

    Returns O in ``q``'s dtype, and with ``return_lse`` also the rows'
    log-sum-exp, (B, H, Sq) float32 (not differentiable).  ``sm_scale``
    defaults to ``1/sqrt(D)``.  Differentiable in q, k and v."""
    _check(q, k, v)
    out, lse = _FlashAttention.apply(q, k, v, bool(causal),
                                     float(_scale(q, sm_scale)))
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
