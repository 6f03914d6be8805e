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
- :func:`fwd_launch_plan` and :func:`bwd_launch_plan` say how the card
  runs the forward and the backward at a head dim and type: the route
  (bf16 and float16 on ``wgmma``, float32 as 3xTF32 on the tensor cores,
  the 256 bucket on the CUDA cores), the tiles and the shared memory of
  each kernel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..base import MXNetError
from .registry import canonical_attr, register

__all__ = ["mha_reference", "flash_attention", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "head_dim_bucket", "HEAD_DIM_BUCKETS", "MAX_HEAD_DIM",
           "fwd_launch_plan", "FwdLaunchPlan", "bwd_launch_plan",
           "BwdLaunchPlan", "flash_attention_op"]

_NEG_INF = -1e30
# the kernels are built for these head dims; a head dim runs in the
# smallest bucket that holds it, its columns past D loaded as zeros and
# never stored.  The plain versions take any D.
HEAD_DIM_BUCKETS = (32, 64, 128, 256)
MAX_HEAD_DIM = HEAD_DIM_BUCKETS[-1]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def head_dim_bucket(d):
    """The head-dim bucket whose kernel instance runs head dim ``d`` on
    the card (the C launchers pick the same one); raises
    :class:`MXNetError` past :data:`MAX_HEAD_DIM`."""
    for bucket in HEAD_DIM_BUCKETS:
        if 1 <= d <= bucket:
            return bucket
    raise MXNetError("flash_attention on the card takes head_dim 1 to %d, "
                     "not %d" % (MAX_HEAD_DIM, d))


def _check_dtype(dtype):
    if dtype not in _DTYPE_CODES:
        raise MXNetError("flash_attention takes float32, bfloat16 or "
                         "float16, not %s" % dtype)


class FwdLaunchPlan(NamedTuple):
    """How the card runs the forward kernel K3 at one head dim and type
    (``csrc/flash_attn_fwd.cu`` dispatches the same)."""

    route: str    # "wgmma", "tf32x3" or "cuda_cores"
    bucket: int   # the head-dim bucket of the kernel instance
    threads: int  # threads of a block
    q_tile: int   # query rows a block owns
    k_step: int   # key rows a step of its loop walks
    stages: int   # slots of the K/V ring (1: loaded in place each step)
    smem: int     # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=None)
def fwd_launch_plan(d, dtype):
    """The :class:`FwdLaunchPlan` of head dim ``d`` in ``dtype``.

    Buckets 32, 64 and 128 run on the tensor cores; every plan adds 1024
    bytes to align the tiles.  bf16 and float16 through ``wgmma``: a
    128-row q-tile owned by two warpgroups (256 threads), 64 keys a step,
    tiles of ``max(bucket, 64)`` 16-bit columns, 128-byte swizzled, and a
    ``cp.async`` ring of four (K, V) stages (a step reads K of its own
    stage and V of the one before, while the next two load).  float32 as
    3xTF32: at buckets 32 and 64 on tf32 ``wgmma`` with the same tiling,
    in float32 tiles of ``bucket`` columns: Q with its lo part, two slots
    each holding K and its lo part and V transposed with its lo part, and
    one staging tile for V as it lands (one block an SM at bucket 64); at
    bucket 128, where that does not fit, on ``mma.sync``: a 64-row q-tile
    of four warps (128 threads), 32 keys a step, rows of ``bucket + 4``
    floats, a ring of two (K, V) stages, each tile followed by its lo
    part.  The 256 bucket keeps the CUDA-core kernel in every type: a
    ``wgmma`` 64-row tile would hold O's 128 float32 accumulators a thread
    beside S's 32 and P's 16 fragment registers and the row state, past
    what a thread keeps in 255 registers; 256 threads over 64 x 64 float32
    tiles padded by one float (Q, K, V and P in shared memory, loaded in
    place)."""
    bucket = head_dim_bucket(d)
    _check_dtype(dtype)
    if bucket == 256:
        b = 64
        smem = 4 * (2 * b * (bucket + 1) + b * bucket + b * (b + 1))
        return FwdLaunchPlan("cuda_cores", bucket, 256, b, b, 1, smem)
    if dtype == torch.float32 and bucket == 128:
        rows, step, stages, row_bytes = 64, 32, 2, (bucket + 4) * 4
        tiles = 2 * (rows + 2 * stages * step)  # each with its lo part
        return FwdLaunchPlan("tf32x3", bucket, 128, rows, step, stages,
                             tiles * row_bytes + 1024)
    rows, step = 128, 64
    if dtype == torch.float32:
        # Q and lo; two slots of K, lo, V^T, lo; the staging tile
        stages, row_bytes = 2, bucket * 4
        return FwdLaunchPlan("tf32x3", bucket, 256, rows, step, stages,
                             (2 * rows + (4 * stages + 1) * step) * row_bytes
                             + 1024)
    stages, row_bytes = 4, max(bucket, 64) * 2
    return FwdLaunchPlan("wgmma", bucket, 256, rows, step, stages,
                         (rows + 2 * stages * step) * row_bytes + 1024)


class BwdLaunchPlan(NamedTuple):
    """How the card runs the backward kernels K4a and K4b at one head dim
    and type (``csrc/flash_attn_bwd.cu`` dispatches the same)."""

    route: str       # "wgmma", "tf32x3" or "cuda_cores"
    bucket: int      # the head-dim bucket of the kernel instances
    threads: int     # threads of a block
    dq_tile: tuple   # K4a: (query rows a block owns, key rows a step)
    dkv_tile: tuple  # K4b: (key rows a block owns, query rows a step)
    dq_smem: int     # dynamic shared memory of a K4a block, bytes
    dkv_smem: int    # the same for K4b


@functools.lru_cache(maxsize=None)
def bwd_launch_plan(d, dtype):
    """The :class:`BwdLaunchPlan` of head dim ``d`` in ``dtype``.

    Buckets 32, 64 and 128 run on the tensor cores with one warpgroup a
    block owning 64 rows: bf16 and float16 through ``wgmma`` (tiles of
    ``max(bucket, 64)`` 16-bit columns, 128-byte swizzled), float32 as
    3xTF32 ``mma.sync`` (rows of ``bucket + 4`` floats).  On ``wgmma`` K4a
    walks 64 keys a step and K4b 64 queries, or 32 at bucket 128, where
    its dK and dV accumulators take 128 registers a thread; on 3xTF32 both
    walk 32, so that three blocks fit on an SM.  Each kernel holds its own
    two tiles and a ring of two stages of the other two (K4b's stages also
    hold lse and delta), plus 1024 bytes of alignment.  The 256 bucket
    keeps the CUDA-core kernels in every type: 256 threads, 32 x 32 float32
    tiles padded by one float."""
    bucket = head_dim_bucket(d)
    _check_dtype(dtype)
    if bucket == 256:
        b, ld = 32, bucket + 1
        tiles = 4 * (4 * b * ld + b * (b + 1))
        return BwdLaunchPlan("cuda_cores", bucket, 256, (b, b), (b, b),
                             tiles, tiles + 4 * 2 * b)
    if dtype == torch.float32:
        route, row_bytes, step_k, step_q = "tf32x3", (bucket + 4) * 4, 32, 32
    else:
        route, row_bytes = "wgmma", max(bucket, 64) * 2
        step_k, step_q = 64, (32 if bucket > 64 else 64)
    rows = 64
    dq = 2 * rows * row_bytes + 4 * step_k * row_bytes + 1024
    dkv = 2 * rows * row_bytes + 4 * step_q * row_bytes + 16 * step_q + 1024
    return BwdLaunchPlan(route, bucket, 128, (rows, step_k), (rows, step_q),
                         dq, dkv)


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
    if sq == 0 or k.shape[2] == 0:
        raise MXNetError("flash_attention needs non-empty sequences")
    if not (q.device == k.device == v.device):
        raise MXNetError("q, k and v lie on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise MXNetError("flash_attention takes q, k, v of one dtype, "
                         "float32, bfloat16 or float16 (got %s, %s, %s)"
                         % (q.dtype, k.dtype, v.dtype))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention takes contiguous q, k, v")
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError("flash_attention runs on CPU or CUDA tensors, "
                         "not %s" % q.device)
    if q.device.type == "cuda":
        head_dim_bucket(d)


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
    _kernels.launch(lib, lib.mxt_flash_attn_fwd, q, k, v, out, lse, b * h,
                    sq, k.shape[2], d, float(scale), int(bool(causal)),
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
    _kernels.launch(lib, lib.mxt_flash_attn_bwd_dq, q, k, v, do, lse, delta,
                    dq, b * h, sq, k.shape[2], d, float(scale),
                    int(bool(causal)), _DTYPE_CODES[q.dtype])
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
    _kernels.launch(lib, lib.mxt_flash_attn_bwd_dkv, q, k, v, do, lse,
                    delta, dk, dv, b * h, sq, k.shape[2], d, float(scale),
                    int(bool(causal)), _DTYPE_CODES[q.dtype])
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
    (float32, bfloat16 or float16), any sequence lengths, any D on the
    CPU and D up to :data:`MAX_HEAD_DIM` on the card.

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


# ---------------------------------------------------------------------------
# registered ops (reference: src/operator/contrib/transformer.cc;
# mxnet_tpu/ops/attention.py:390-450)
# ---------------------------------------------------------------------------


@register("_contrib_flash_attention", aliases=("flash_attention",))
def flash_attention_op(query, key, value, causal=False, sm_scale=None, **_):
    """Fused scaled-dot-product attention over (B, H, S, D) q, k, v: the
    registry face of :func:`flash_attention` (K3 forward, K4a/K4b
    backward on the card).  The operands may be strided views (a symbol
    graph slices a transposed qkv): they are made contiguous here.
    ``causal`` and ``sm_scale`` may come as a symbol file's strings
    (``"True"``, ``"None"``).  On ``meta`` tensors (shape inference) the
    result's shape is given without reaching a kernel."""
    causal, sm_scale = canonical_attr(causal), canonical_attr(sm_scale)
    if query.device.type == "meta":
        return torch.empty_like(query)
    return flash_attention(query.contiguous(), key.contiguous(),
                           value.contiguous(), causal=bool(causal),
                           sm_scale=sm_scale)


@register("_contrib_div_sqrt_dim", aliases=("div_sqrt_dim",))
def div_sqrt_dim(data, **_):
    """``data / sqrt(data.shape[-1])``."""
    return data / math.sqrt(data.shape[-1])


def _interleaved(qkv, heads, which):
    """Head-major (B*heads, S, d) float32 slices of the interleaved (S, B,
    3*proj) projection: ``which`` 0 for q, 1 for k, 2 for v."""
    s, b, p3 = qkv.shape
    d = p3 // 3 // heads
    x = qkv.reshape(s, b, heads, 3, d)[:, :, :, which, :]
    return x.permute(1, 2, 0, 3).reshape(b * heads, s, d).float()


@register("_contrib_interleaved_matmul_selfatt_qk",
          aliases=("interleaved_matmul_selfatt_qk",))
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1, **_):
    """Scores ``q k^T`` from the interleaved (seq, batch, 3*proj) layout,
    (batch*heads, seq, seq), summed in float32 and returned in the
    input's type (the JAX package computes it outside any kernel)."""
    heads = int(heads)
    q = _interleaved(queries_keys_values, heads, 0)
    k = _interleaved(queries_keys_values, heads, 1)
    return torch.bmm(q, k.transpose(1, 2)).to(queries_keys_values.dtype)


@register("_contrib_interleaved_matmul_selfatt_valatt",
          aliases=("interleaved_matmul_selfatt_valatt",))
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1, **_):
    """``attention @ v`` back in the (seq, batch, proj) layout, summed in
    float32 and returned in the input's type."""
    heads = int(heads)
    s, b, p3 = queries_keys_values.shape
    v = _interleaved(queries_keys_values, heads, 2)
    out = torch.bmm(attention.float(), v)
    return out.reshape(b, heads, s, -1).permute(2, 0, 1, 3).reshape(
        s, b, p3 // 3).to(queries_keys_values.dtype)
