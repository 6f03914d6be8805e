"""Batch normalization forward and backward of the PyTorch port (K6a, K6b).

Not the counterpart of a Pallas kernel: the JAX package leaves BatchNorm
to XLA (``mxnet_tpu/ops/nn.py:461-515``), which fuses its statistics,
normalisation and affine inside the jitted step.  Here they are two
hand-written Hopper kernels, ``csrc/batch_norm.cu``, over channel-last
data seen as ``M`` rows of ``C`` contiguous channels, in float32,
bfloat16 and float16, with the JAX package's arithmetic:

- forward, train mode: bf16/f16 data, one pass of float32 sums of x and
  x^2, ``var = max(E[x^2] - E[x]^2, 0)``, mean and var rounded to the
  data's type; float32 data, the mean, then the biased variance in a
  second pass.  ``inv = rsqrt(var + eps)`` in float32, ``scale = gamma *
  inv`` (gamma 1 under ``fix_gamma``) and ``beta`` rounded to the data's
  type, ``y = ((x - mean) * scale) + beta`` with each operation rounded
  to it.  With ``momentum`` the running statistics move in place, as the
  Gluon layer writes it: ``running * m + stat * (1 - m)``;
- forward, predict mode (``use_global_stats``): the same apply over the
  running statistics;
- backward: ``S1 = sum dy`` and ``S2 = sum dy (x - mean)`` in float32,
  ``dbeta = S1``, ``dgamma = inv S2`` (0 under ``fix_gamma``) and
  ``dx = scale (dy - S1/M) - gamma inv^3 (x - mean) S2/M`` (predict mode:
  ``scale dy``), rounded once to the data's type.  JAX's autodiff rounds
  each intermediate to bf16; this is the port's one deliberate
  divergence here (ROADMAP, Queue 3).

:func:`batch_norm_fwd_plain` and :func:`batch_norm_bwd_plain` are the
plain versions, written in the kernels' operation order, so that the
kernels equal them wherever the float32 sums agree.
:func:`batch_norm_fwd` (K6a) and :func:`batch_norm_bwd` (K6b) launch the
kernels on CUDA tensors, with no fallback, and take the plain versions on
CPU tensors; each counts its launches in ``.launches``.
:func:`batch_norm` is the differentiable op over any axis: the kernels
see the channel axis last, so NCHW data (``axis=1``) goes through its
NHWC view, free when the tensor is ``channels_last`` in memory (as the
port's NCHW convolutions leave it) and one copy otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _kernels
from ..base import MXNetError

__all__ = ["batch_norm", "batch_norm_fwd", "batch_norm_bwd",
           "batch_norm_fwd_plain", "batch_norm_bwd_plain", "launch_plan",
           "LaunchPlan", "Occupancy"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMS = 132              # streaming multiprocessors of an H100
THREADS = 256           # a block of the row passes
TARGET_BLOCKS = 4 * _SMS
# the co-resident blocks an SM of the streamed route (the kernels' launch
# bounds allow them); an H100's shared memory, an SM, a block and reserved
# a block; a round of a block's slab, 16 bytes a thread of x and dy (K6b)
# or of x (K6a)
BWD_BLOCKS_PER_SM = 4
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233472, 232448, 1024
ROUND_BYTES = 2 * THREADS * 16
FWD_ROUND_BYTES = THREADS * 16
# rows of the per-channel state ``stats`` (float32, (4, C)): the mean,
# the scale and shift as the apply pass uses them, and rsqrt(var + eps)
MEAN, SCALE, SHIFT, INV = range(4)


class Occupancy(NamedTuple):
    """What a plan asks of the occupancy API for one kernel: the C entry
    that answers for the kernel, its arguments before the output (the
    type code, the access, K6b's route and the dynamic shared memory), the
    blocks an SM that the plan assumes co-resident and its grid."""
    entry: str
    args: tuple
    blocks_per_sm: int
    grid: int


class LaunchPlan(NamedTuple):
    """How K6a and K6b cover an (M, C) tensor.  ``access``: ``"16-byte"``
    (``vec`` channels a load: 8 of bf16 or float16, 4 of float32) or
    ``"scalar"`` (``vec`` 1, where C or a pointer's alignment does not
    allow 16 bytes).  A (split, channel tile) item of 256 threads takes
    ``tile_c`` channels (``tpr`` threads a row, ``tpr * vec`` channels)
    and ``rows_at_once`` = 256 / ``tpr`` rows at a time;
    ``channel_tiles`` items cover C and ``splits`` items the rows,
    ``rows`` rows each (the last one shorter).  The forward's workspace
    holds ``fwd_ws`` float32 partial sums, the backward's ``bwd_ws`` (the
    partial sums and three coefficients a channel).

    K6b is one cooperative launch of ``bwd_grid`` co-resident blocks over
    the items, launched as the plan says (the kernel takes the route,
    grid, shared memory, splits a block and rounds kept from it).
    ``route`` ``"resident"``: a block takes ``splits_per_block``
    consecutive splits of a tile (``rounds`` rows a thread), whose x and
    dy rows stay in ``bwd_smem`` bytes of dynamic shared memory between
    its two phases, ``blocks_per_sm`` blocks an SM; ``"streamed"``: at
    most ``blocks_per_sm`` (4) blocks an SM walk the items (``rounds``
    rows a thread each), reading x and dy again for dx but for the first
    ``kept_rounds`` of each thread's rows, which stay in ``bwd_smem``
    bytes where a block has one item.  The ``fwd_`` fields are K6a's
    launch, on the streamed route at every shape, its kept rounds of x
    alone.  Every route writes the same partial sums, those of the items,
    so the results of K6b do not depend on it."""
    access: str
    vec: int
    tpr: int
    rows_at_once: int
    tile_c: int
    channel_tiles: int
    splits: int
    rows: int
    fwd_ws: int
    bwd_ws: int
    route: str
    splits_per_block: int
    rounds: int
    kept_rounds: int
    bwd_grid: int
    bwd_smem: int
    blocks_per_sm: int
    fwd_kept_rounds: int
    fwd_grid: int
    fwd_smem: int
    fwd_blocks_per_sm: int

    def fwd_occupancy(self, code):
        """K6a's :class:`Occupancy` for data of type code ``code``."""
        return Occupancy("mxt_bn_fwd_occupancy",
                         (code, self.vec, self.fwd_smem),
                         self.fwd_blocks_per_sm, self.fwd_grid)

    def bwd_occupancy(self, code):
        """K6b's :class:`Occupancy` for data of type code ``code``."""
        return Occupancy("mxt_bn_bwd_occupancy",
                         (code, self.vec, int(self.route == "resident"),
                          self.bwd_smem), self.blocks_per_sm, self.bwd_grid)


def _red_bytes(vec, sums=2):
    """A block's static shared memory: ``sums`` x 256 x ``vec`` float32
    partial sums (K6b and K6a in bf16 and float16 add two a channel, K6a
    in float32 one)."""
    return sums * THREADS * vec * 4


def _resident_blocks_per_sm(rounds, vec):
    """Blocks an SM that a resident slab of ``rounds`` rounds leaves room
    for, at most :data:`BWD_BLOCKS_PER_SM`; 0 where one does not fit."""
    block = rounds * ROUND_BYTES + _red_bytes(vec)
    if block > SMEM_PER_BLOCK:
        return 0
    return min(BWD_BLOCKS_PER_SM, SMEM_PER_SM // (block + SMEM_RESERVED))


def _resident_route(splits, rps, vec, tiles, sms):
    """K6b's resident launch over ``splits`` splits of ``rps`` rounds a
    thread and ``tiles`` channel tiles on ``sms`` SMs: a block takes the
    fewest consecutive splits whose slabs fit with every block
    co-resident; None where no such grouping fits (or ``vec`` is 1:
    cp.async copies 16 bytes)."""
    spb = 1
    while vec > 1:
        bps = _resident_blocks_per_sm(spb * rps, vec)
        if bps == 0:
            return None
        groups = -(-splits // spb)
        if groups * tiles <= sms * bps:
            kept = spb * rps
            return ("resident", spb, kept, kept, groups * tiles,
                    kept * ROUND_BYTES, bps)
        if groups == 1:
            return None
        spb += 1
    return None


def _streamed_route(splits, rps, vec, tiles, sms, round_bytes=ROUND_BYTES,
                    red=None):
    """The streamed launch: at most :data:`BWD_BLOCKS_PER_SM` blocks an
    SM; a block of one item keeps the first rounds (of ``round_bytes``,
    beside ``red`` bytes of static shared memory; K6b's by default) that
    fit beside three others."""
    red = _red_bytes(vec) if red is None else red
    cap = BWD_BLOCKS_PER_SM * sms
    keep = (SMEM_PER_SM // BWD_BLOCKS_PER_SM - SMEM_RESERVED
            - red) // round_bytes
    kept = min(rps, keep) if vec > 1 and splits * tiles <= cap else 0
    return ("streamed", 1, rps, kept, min(splits * tiles, cap),
            kept * round_bytes, BWD_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def launch_plan(m, c, dtype, aligned=True, sms=_SMS):
    """The :class:`LaunchPlan` of an (``m``, ``c``) tensor in ``dtype``
    (``aligned``: the tensors lie on 16-byte boundaries) on a card of
    ``sms`` SMs: a pure function of the shapes.  The channels go to as
    few threads a row as hold them, at most 32; the rows are cut into as
    many splits as put about :data:`TARGET_BLOCKS` items (four an SM of
    an H100) in flight, no split shorter than one round of rows.  K6b's
    route is resident where a grouping of the splits fits its slab, else
    streamed; K6a streams at every shape."""
    if m < 1 or c < 1:
        raise MXNetError("batch_norm takes at least one row and one channel "
                         "(got M=%d, C=%d)" % (m, c))
    esize = torch.finfo(dtype).bits // 8
    vec = 16 // esize
    if not aligned or c % vec:
        vec = 1
    nvec = -(-c // vec)
    tpr = min(32, 1 << (nvec - 1).bit_length())
    rows_at_once = THREADS // tpr
    tiles = -(-nvec // tpr)
    splits = max(1, min(-(-TARGET_BLOCKS // tiles),
                        -(-m // rows_at_once)))
    rows = -(-m // splits)
    splits = -(-m // rows)
    part = 2 * c * splits
    rps = -(-rows // rows_at_once)
    route = (_resident_route(splits, rps, vec, tiles, sms)
             or _streamed_route(splits, rps, vec, tiles, sms))
    fwd = _streamed_route(splits, rps, vec, tiles, sms, FWD_ROUND_BYTES,
                          _red_bytes(vec, 2 if esize == 2 else 1))
    return LaunchPlan("16-byte" if vec > 1 else "scalar", vec, tpr,
                      rows_at_once, tpr * vec, tiles, splits, rows, part,
                      part + 3 * c, *route, *fwd[3:])


def batch_norm_fwd_plain(x, gamma, beta, running_mean, running_var, eps,
                         fix_gamma, use_global_stats, momentum=None):
    """The plain forward of (M, C) ``x``: ``(y, mean, var, stats)``,
    ``mean`` and ``var`` the statistics used (the running ones in predict
    mode), ``stats`` the per-channel state the backward reads.  With
    ``momentum`` (train mode) the running statistics move in place."""
    m = x.shape[0]
    dt = x.dtype
    if use_global_stats:
        mean, var = running_mean, running_var
        mean_d, var_f = running_mean.to(dt), running_var.float()
    elif dt in (torch.bfloat16, torch.float16):
        xf = x.float()
        mu = xf.sum(0) / m
        var = torch.clamp_min(xf.square().sum(0) / m - mu.square(), 0.0)
        mean, var = mu.to(dt), var.to(dt)
        mean_d, var_f = mean, var.float()
    else:
        mean = x.sum(0) / m
        var = (x - mean).square().sum(0) / m
        mean_d, var_f = mean, var
    inv = torch.rsqrt(var_f + eps)
    g = torch.ones_like(inv) if fix_gamma else gamma.float()
    scale = (g * inv).to(dt)
    shift = beta.to(dt)
    y = (x - mean_d) * scale + shift
    if momentum is not None and not use_global_stats:
        with torch.no_grad():
            running_mean.copy_(running_mean * momentum
                               + mean * (1 - momentum))
            running_var.copy_(running_var * momentum + var * (1 - momentum))
    stats = torch.stack([mean_d.float(), scale.float(), shift.float(), inv])
    return y, mean, var, stats


def batch_norm_bwd_plain(x, dy, stats, gamma, beta, fix_gamma, train):
    """The plain backward of (M, C) ``x`` from ``dy`` and the forward's
    ``stats``: ``(dx, dgamma, dbeta)`` in the types of ``x``, ``gamma``
    and ``beta``."""
    m = x.shape[0]
    mean, scale, inv = stats[MEAN], stats[SCALE], stats[INV]
    xf, dyf = x.float(), dy.float()
    sdy = dyf.sum(0)
    sdxm = (dyf * (xf - mean)).sum(0)
    if train:
        g = torch.ones_like(inv) if fix_gamma else gamma.float()
        k2 = sdy / m
        k3 = (g * inv) * (inv * inv) * sdxm / m
    else:  # the running statistics do not depend on x
        k2 = k3 = torch.zeros_like(sdy)
    dx = scale * (dyf - k2) - k3 * (xf - mean)
    dgamma = torch.zeros_like(sdxm) if fix_gamma else inv * sdxm
    return dx.to(x.dtype), dgamma.to(gamma.dtype), sdy.to(beta.dtype)


def _code(t, what):
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise MXNetError("batch_norm: %s must be float32, bfloat16 or "
                         "float16, not %s" % (what, t.dtype))
    return code


def _check_params(x, gamma, beta, running_mean, running_var):
    c = x.shape[1]
    for t, what in ((gamma, "gamma"), (beta, "beta"),
                    (running_mean, "running_mean"),
                    (running_var, "running_var")):
        if tuple(t.shape) != (c,) or t.device != x.device:
            raise MXNetError("batch_norm: %s must be (%d,) on %s, got %s on "
                             "%s" % (what, c, x.device, tuple(t.shape),
                                     t.device))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(x, *tensors):
    m, c = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + tensors)
    if x.device.type != "cuda":
        return launch_plan(m, c, x.dtype, aligned)
    return launch_plan(m, c, x.dtype, aligned, _sm_count(x.device.index))


_held: set = set()  # the plans held to the occupancy API, by device


def _hold_to_occupancy(lib, occ, device):
    """Raise unless the occupancy API, asked through ``lib``'s entry of
    :class:`Occupancy` ``occ``, lets its blocks an SM be co-resident on
    ``device``; asked once for each device, entry and arguments."""
    key = (device.index, occ.entry, occ.args, occ.blocks_per_sm)
    if key in _held:
        return
    blocks = ctypes.c_int()
    with torch.cuda.device(device):
        err = getattr(lib, occ.entry)(*occ.args, ctypes.byref(blocks))
    if err:
        raise MXNetError("batch_norm: %s failed: %s" % (
            occ.entry, lib.mxt_error_string(err).decode()))
    if blocks.value < occ.blocks_per_sm:
        raise MXNetError(
            "batch_norm: the plan puts %d blocks an SM of the kernel that %s "
            "answers for, at %s; the occupancy API allows %d"
            % (occ.blocks_per_sm, occ.entry, occ.args, blocks.value))
    _held.add(key)


def batch_norm_fwd(x, gamma, beta, running_mean, running_var, eps,
                   fix_gamma, use_global_stats, momentum=None):
    """K6a on a CUDA (M, C) ``x``, the plain forward on a CPU one:
    ``(y, mean, var, stats)`` as :func:`batch_norm_fwd_plain` returns
    them.  On the card x must be contiguous, float32, bfloat16 or
    float16, and the running statistics float32."""
    if x.dim() != 2:
        raise MXNetError("batch_norm_fwd takes (M, C) data")
    _check_params(x, gamma, beta, running_mean, running_var)
    if x.device.type in ("cpu", "meta"):  # meta: shapes only
        return batch_norm_fwd_plain(x, gamma, beta, running_mean,
                                    running_var, eps, fix_gamma,
                                    use_global_stats, momentum)
    if x.device.type != "cuda":
        raise MXNetError("batch_norm runs on CPU or CUDA tensors, not %s"
                         % x.device)
    return _launch_fwd(x, gamma, beta, running_mean, running_var, eps,
                       fix_gamma, use_global_stats, momentum)


def _launch_fwd(x, gamma, beta, running_mean, running_var, eps, fix_gamma,
                use_global_stats, momentum):
    """K6a's launch for :func:`batch_norm_fwd`: one cooperative launch of
    the plan's forward grid, held to the occupancy API."""
    code = _code(x, "the data")
    if running_mean.dtype != torch.float32 \
            or running_var.dtype != torch.float32:
        raise MXNetError("batch_norm on the card keeps the running "
                         "statistics in float32, not %s"
                         % running_mean.dtype)
    if not x.is_contiguous():
        raise MXNetError("batch_norm_fwd takes contiguous (M, C) data")
    m, c = x.shape
    gamma, beta = gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x)
    train = not use_global_stats
    mean = torch.empty(c, dtype=x.dtype, device=x.device) if train else None
    var = torch.empty(c, dtype=x.dtype, device=x.device) if train else None
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    plan = _plan_for(x, y)
    ws = torch.empty(plan.fwd_ws if train else 1, dtype=torch.float32,
                     device=x.device)
    if not train:
        mode = 2
    else:
        mode = 1 if momentum is not None else 0
    mom = 0.0 if momentum is None else float(momentum)
    lib = _kernels.library("batch_norm")
    _hold_to_occupancy(lib, plan.fwd_occupancy(code), x.device)
    _kernels.launch(lib, lib.mxt_bn_fwd, x, gamma, beta, running_mean,
                    running_var, y, mean if train else 0,
                    var if train else 0, stats, ws, m, c, plan.vec,
                    plan.tpr, plan.splits, plan.rows, code,
                    _code(gamma, "gamma"), _code(beta, "beta"), mode,
                    int(bool(fix_gamma)), float(eps), mom, 1.0 - mom,
                    plan.fwd_grid, plan.fwd_smem, plan.fwd_kept_rounds)
    batch_norm_fwd.launches += 1
    if not train:
        mean, var = running_mean, running_var
    return y, mean, var, stats


def batch_norm_bwd(x, dy, stats, gamma, beta, fix_gamma, train):
    """K6b on CUDA tensors, the plain backward on CPU ones: ``(dx,
    dgamma, dbeta)`` of (M, C) ``x`` and ``dy`` (contiguous, one dtype)
    from the forward's ``stats``."""
    if x.shape != dy.shape or x.dtype != dy.dtype or x.dim() != 2:
        raise MXNetError("batch_norm_bwd takes (M, C) x and dy of one shape "
                         "and dtype (got %s %s, %s %s)" % (
                             tuple(x.shape), x.dtype, tuple(dy.shape),
                             dy.dtype))
    if x.device.type == "cpu":
        return batch_norm_bwd_plain(x, dy, stats, gamma, beta, fix_gamma,
                                    train)
    code = _code(x, "the data")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise MXNetError("batch_norm_bwd takes contiguous (M, C) x and dy")
    m, c = x.shape
    gamma = gamma.contiguous()
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=gamma.dtype, device=x.device)
    dbeta = torch.empty(c, dtype=beta.dtype, device=x.device)
    plan = _plan_for(x, dy, dx)
    ws = torch.empty(plan.bwd_ws, dtype=torch.float32, device=x.device)
    lib = _kernels.library("batch_norm")
    _hold_to_occupancy(lib, plan.bwd_occupancy(code), x.device)
    _kernels.launch(lib, lib.mxt_bn_bwd, x, dy, stats, gamma, dx, dgamma,
                    dbeta, ws, m, c, plan.vec, plan.tpr, plan.splits,
                    plan.rows, code, _code(gamma, "gamma"),
                    _code(beta, "beta"), int(bool(train)),
                    int(bool(fix_gamma)), int(plan.route == "resident"),
                    plan.bwd_grid, plan.bwd_smem, plan.splits_per_block,
                    plan.kept_rounds)
    batch_norm_bwd.launches += 1
    return dx, dgamma, dbeta


batch_norm_fwd.launches = 0
batch_norm_bwd.launches = 0


class _BatchNorm(torch.autograd.Function):
    """BatchNorm of (M, C) data: K6a forward, K6b backward (the plain
    versions on the CPU).  Train mode returns ``(y, mean, var)``, the
    statistics not differentiable; predict mode returns ``y``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, eps,
                fix_gamma, use_global_stats, momentum):
        y, mean, var, stats = batch_norm_fwd(
            x, gamma, beta, running_mean, running_var, eps, fix_gamma,
            use_global_stats, momentum)
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.fix_gamma, ctx.train = fix_gamma, not use_global_stats
        if use_global_stats:
            return y
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, *_):
        x, gamma, beta, stats = ctx.saved_tensors
        dx, dgamma, dbeta = batch_norm_bwd(x, dy.contiguous(), stats, gamma,
                                           beta, ctx.fix_gamma, ctx.train)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None) + (None,) * 6


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               fix_gamma=True, use_global_stats=False, axis=1,
               momentum=None):
    """Batch normalization over ``axis`` (reference:
    src/operator/nn/batch_norm.cc; ``mxnet_tpu/ops/nn.py:462``):
    ``(out, mean, var)``, the statistics used (the batch's unless
    ``use_global_stats``).  With ``momentum`` (the Gluon layer's), train
    mode also moves the running statistics in place; otherwise they are
    the caller's to update.

    K6a and K6b run on the data with ``axis`` moved last: a view where
    that axis is already innermost in memory (NHWC data, or NCHW data
    with ``channels_last`` strides), else one copy; the result is moved
    back, so it keeps the input's memory order."""
    ax = axis % data.dim()
    last = ax == data.dim() - 1
    x = data if last else data.movedim(ax, -1)
    shape = x.shape
    x2 = x.contiguous().reshape(-1, shape[-1])
    out = _BatchNorm.apply(x2, gamma, beta, moving_mean, moving_var, eps,
                           bool(fix_gamma), bool(use_global_stats),
                           None if use_global_stats else momentum)
    if use_global_stats:
        y, mean, var = out, moving_mean, moving_var
    else:
        y, mean, var = out
    y = y.reshape(shape)
    return (y if last else y.movedim(-1, ax)), mean, var
