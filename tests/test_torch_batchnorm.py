"""The port's BatchNorm (mxnet_tpu_torch/ops/nn.py batch_norm, the plain
versions of K6a and K6b in ops/batch_norm.py, and the gluon.nn.BatchNorm
layer) against the JAX package, on the CPU.

Tolerances:
- float32: 1e-5 (rtol and atol), the mean and the two-pass variance
  summed in another order by each package;
- bf16 data: one bf16 step (2**-7 relative, plus 1e-2 absolute for
  outputs near 0) for the output, the mean and the variance: both
  packages sum E[x] and E[x^2] in float32 and round the results to bf16,
  and a float32 sum in another order may land one bf16 step away;
- the running statistics (float32 in both): 1e-5, and one step of the
  data's type times (1 - momentum) where the batch statistics are bf16
  or float16;
- the plain forward of K6a (NHWC, C = 5, M = 792, a multiple of no
  tile): float32 1e-5; bf16 and float16 one step of the type (measured:
  equal);
- the plain backward of K6b against jax.vjp of the JAX op: float32 within
  1e-5 of each gradient's largest magnitude (measured: 3e-7); bf16 and
  float16, which K6b rounds once where JAX's autodiff rounds each
  intermediate (and sums dy in the data's type), dx within one step of
  the type and dgamma, dbeta within sixteen steps, of the largest
  magnitude (measured: 0.7 and 10.5 steps, the latter JAX's bf16 sum
  over 792 rows), and every gradient at least as close to the float64
  gradient of the same inputs as JAX's.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd
from mxnet_tpu.gluon import nn as jgnn
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import MXNetError as tmx_error
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.ops import batch_norm as tbn
from mxnet_tpu_torch.ops import nn as tnn

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -7, atol=1e-2)
# the spacing of each half type at 1.0
STEP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _inputs(shape, axis, seed=0):
    rs = np.random.RandomState(seed)
    c = shape[axis]
    x = (rs.normal(size=shape) * 2 + 0.5).astype(np.float32)
    stats = [rs.normal(size=c).astype(np.float32) for _ in range(3)]
    stats.append(rs.rand(c).astype(np.float32) + 0.5)  # moving var
    return x, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis,shape", [(3, (4, 5, 6, 8)), (1, (4, 8, 5, 6)),
                                        (-1, (6, 16))])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("use_global_stats", [False, True])
def test_batch_norm_op_matches_jax(dtype, axis, shape, fix_gamma,
                                   use_global_stats):
    x, (gamma, beta, mm, mv) = _inputs(shape, axis)
    jx = jnp.asarray(x).astype(dtype)
    want = jnn.batch_norm(jx, *(jnp.asarray(a) for a in (gamma, beta, mm, mv)),
                          eps=1e-5, fix_gamma=fix_gamma,
                          use_global_stats=use_global_stats,
                          output_mean_var=True, axis=axis)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tnn.batch_norm(tx, *(torch.from_numpy(a)
                               for a in (gamma, beta, mm, mv)),
                         eps=1e-5, fix_gamma=fix_gamma,
                         use_global_stats=use_global_stats, axis=axis)
    tol = F32 if dtype == "float32" else BF16
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)


def test_batch_norm_op_gradients_match_jax():
    x, (gamma, beta, mm, mv) = _inputs((4, 5, 6, 8), 3, seed=1)

    def jfn(x_, g_, b_):
        return jnn.batch_norm(x_, g_, b_, jnp.asarray(mm), jnp.asarray(mv),
                              eps=1e-5, fix_gamma=False, axis=3)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, gamma, beta)))
    dy = np.random.RandomState(2).normal(size=want.shape).astype(np.float32)
    wgrads = vjp(jnp.asarray(dy))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    out, _, _ = tnn.batch_norm(tx, tg, tb, torch.from_numpy(mm),
                               torch.from_numpy(mv), eps=1e-5,
                               fix_gamma=False, axis=3)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32)
    for t, w in zip((tx, tg, tb), wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _layers(c):
    jl = jgnn.BatchNorm(axis=3, in_channels=c)
    jl.initialize()
    tl = tgnn.BatchNorm(axis=3, in_channels=c, device="cpu").initialize()
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == {
        k: (c,) for k in ("gamma", "beta", "running_mean", "running_var")}
    assert [p.grad_req for p in tl.collect_params().values()] == [
        "write", "write", "null", "null"]
    return jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_layer_updates_running_stats_in_train_mode_as_jax(dtype):
    """Two train-mode calls fold the batch statistics into the running
    ones (momentum 0.9, biased variance); predict mode then normalises
    by them.  The running statistics stay float32."""
    c = 8
    jl, tl = _layers(c)
    xs = [(np.random.RandomState(s).normal(size=(4, 5, 5, c)) * 3 + 1)
          .astype(np.float32) for s in (3, 4)]
    for x in xs:
        jx = nd.array(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        with jag.record():
            want = jl(jx)
        with tag.record():
            got = tl(tx)
        tol = F32 if dtype == "float32" else BF16
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   want.astype("float32").asnumpy(), **tol)
        assert got.dtype == getattr(torch, dtype)
    batch = {"running_mean": [x.mean(axis=(0, 1, 2)) for x in xs],
             "running_var": [x.var(axis=(0, 1, 2)) for x in xs]}
    for name in ("running_mean", "running_var"):
        got = getattr(tl, name)
        assert got.dtype == torch.float32 and not got.requires_grad
        want = getattr(jl, name).data().asnumpy()
        if dtype == "float32":
            np.testing.assert_allclose(got.detach().numpy(), want, **F32)
        else:  # one step of each batch statistic, times 1 - momentum
            bound = sum(0.1 * STEP[dtype] * np.abs(b) for b in batch[name])
            assert (np.abs(got.detach().numpy() - want) <= bound + 1e-6).all()
    # the running variance folded in the biased batch variance
    if dtype == "float32":
        want_var = 1.0
        for x in xs:
            want_var = want_var * 0.9 + x.var(axis=(0, 1, 2)) * 0.1
        np.testing.assert_allclose(tl.running_var.detach().numpy(), want_var,
                                   rtol=1e-5)
    # predict mode, from the JAX layer's running statistics: they are
    # used, and not updated
    with torch.no_grad():
        for name in ("running_mean", "running_var"):
            getattr(tl, name).copy_(torch.from_numpy(
                getattr(jl, name).data().asnumpy()))
    x = xs[0]
    before = tl.running_mean.detach().clone()
    want = jl(nd.array(x)).asnumpy()
    got = tl(torch.from_numpy(x))
    assert torch.equal(tl.running_mean.detach(), before)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_layer_use_global_stats_and_fixed_gamma():
    tl = tgnn.BatchNorm(axis=3, in_channels=4, scale=False, center=False,
                        use_global_stats=True, device="cpu").initialize()
    assert tl.gamma.grad_req == "null" and tl.beta.grad_req == "null"
    with torch.no_grad():
        tl.gamma.fill_(5.0)  # ignored: fix_gamma
        tl.running_var.fill_(4.0)
    x = torch.full((2, 3, 3, 4), 2.0)
    with tag.record():
        out = tl(x)
    assert torch.equal(tl.running_mean.detach(), torch.zeros(4))
    torch.testing.assert_close(out, x / torch.sqrt(torch.tensor(4.0 + 1e-5)))


# NHWC with C = 5 (the kernels' scalar path) and M = 8 * 9 * 11 = 792 rows,
# a multiple of no tile of the launch plan
NHWC = (8, 9, 11, 5)


def _nhwc_case(dtype, seed):
    x, (gamma, beta, mm, mv) = _inputs(NHWC, 3, seed=seed)
    dy = np.random.RandomState(seed + 100).normal(size=NHWC).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jdy = jnp.asarray(dy).astype(dtype)
    tdt = getattr(torch, dtype)

    def port(a):  # the JAX-rounded values, as (M, C) in the port's type
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            tdt).reshape(-1, NHWC[3])

    return (jx, jdy, port(jx), port(jdy),
            [torch.from_numpy(a) for a in (gamma, beta, mm, mv)],
            [jnp.asarray(a) for a in (gamma, beta, mm, mv)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("use_global_stats", [False, True])
def test_plain_forward_matches_jax(dtype, fix_gamma, use_global_stats):
    jx, _, tx, _, tp, jp = _nhwc_case(dtype, 5)
    want = jnn.batch_norm(jx, *jp, eps=1e-5, fix_gamma=fix_gamma,
                          use_global_stats=use_global_stats,
                          output_mean_var=True, axis=3)
    y, mean, var, stats = tbn.batch_norm_fwd_plain(
        tx, *tp, 1e-5, fix_gamma, use_global_stats)
    assert y.dtype == tx.dtype and stats.shape == (4, NHWC[3])
    tol = F32 if dtype == "float32" else dict(rtol=STEP[dtype], atol=1e-2)
    for g, w in zip((y.reshape(NHWC), mean, var), want):
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64).reshape(want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_plain_backward_matches_jax_grad(dtype, fix_gamma, train):
    jx, jdy, tx, tdy, tp, jp = _nhwc_case(dtype, 6)

    def jfn(x_, g_, b_):
        return jnn.batch_norm(x_, g_, b_, jp[2], jp[3], eps=1e-5,
                              fix_gamma=fix_gamma,
                              use_global_stats=not train, axis=3)

    _, vjp = jax.vjp(jfn, jx, jp[0], jp[1])
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jdy)]
    _, _, _, stats = tbn.batch_norm_fwd_plain(tx, *tp, 1e-5, fix_gamma,
                                              not train)
    got = tbn.batch_norm_bwd_plain(tx, tdy, stats, tp[0], tp[1], fix_gamma,
                                   train)
    assert [g.dtype for g in got] == [tx.dtype, torch.float32, torch.float32]
    got = [g.float().numpy() for g in got]
    if dtype == "float32":
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-5
        return
    step = STEP[dtype]
    assert _rel(got[0], want[0]) <= step
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g, w) <= 16 * step
    # the float64 gradient of the same inputs: the derivative of the
    # forward, without rounding
    x = tx.double().numpy()
    dy = tdy.double().numpy()
    gamma = np.ones(NHWC[3]) if fix_gamma else tp[0].double().numpy()
    if train:
        mu, var = x.mean(0), x.var(0)
    else:
        mu, var = tp[2].double().numpy(), tp[3].double().numpy()
    inv = 1.0 / np.sqrt(var + 1e-5)
    xhat = (x - mu) * inv
    if train:
        dx = gamma * inv * (dy - dy.mean(0) - xhat * (dy * xhat).mean(0))
    else:
        dx = gamma * inv * dy
    exact = [dx, (0.0 if fix_gamma else 1.0) * (dy * xhat).sum(0),
             dy.sum(0)]
    for g, w, e in zip(got, want, exact):
        assert _rel(g, e) <= _rel(w, e) + 1e-7


@pytest.mark.parametrize("m,c,dtype,want", [
    # the stem's BatchNorm of ResNet-50 at batch 128: 16-byte loads, one
    # channel tile, 528 row splits
    (1605632, 64, torch.bfloat16, ("16-byte", 8, 8, 64, 1, 528)),
    # layer 4's: 8 channel tiles of 256, 66 splits
    (6272, 2048, torch.bfloat16, ("16-byte", 8, 32, 256, 8, 66)),
    (6272, 2048, torch.float32, ("16-byte", 4, 32, 128, 16, 33)),
    # C = 5: the scalar path, 8 threads a row (3 idle)
    (792, 5, torch.float16, ("scalar", 1, 8, 8, 1, 25)),
    # a tiny M: one split
    (3, 64, torch.bfloat16, ("16-byte", 8, 8, 64, 1, 1)),
])
def test_launch_plan(m, c, dtype, want):
    plan = tbn.launch_plan(m, c, dtype)
    assert (plan.access, plan.vec, plan.tpr, plan.tile_c,
            plan.channel_tiles, plan.splits) == want
    assert plan.splits * plan.rows >= m > (plan.splits - 1) * plan.rows
    assert plan.tpr * plan.rows_at_once == tbn.THREADS
    assert plan.channel_tiles * plan.tile_c >= c
    assert plan.fwd_ws == 2 * c * plan.splits
    assert plan.bwd_ws == plan.fwd_ws + 3 * c
    if m >= 6272:  # both ends of ResNet-50 keep the 132 SMs busy
        assert plan.splits * plan.channel_tiles >= 4 * 132 - \
            plan.channel_tiles
    # a misaligned pointer takes the scalar path
    assert tbn.launch_plan(m, c, dtype, aligned=False).vec == 1


def test_launch_plan_refuses_empty():
    with pytest.raises(tmx_error):
        tbn.launch_plan(0, 4, torch.float32)


def test_cpu_runs_the_plain_versions_and_launches_nothing():
    before = (tbn.batch_norm_fwd.launches, tbn.batch_norm_bwd.launches)
    x = torch.randn(4, 3, 5, 6, requires_grad=True)
    gamma = torch.rand(6, requires_grad=True)
    beta = torch.rand(6, requires_grad=True)
    rm, rv = torch.zeros(6), torch.ones(6)
    out, mean, var = tnn.batch_norm(x, gamma, beta, rm, rv, eps=1e-5,
                                    fix_gamma=False, axis=3, momentum=0.9)
    out.sum().backward()
    assert not mean.requires_grad and not var.requires_grad
    assert all(t.grad is not None for t in (x, gamma, beta))
    # momentum moves the running statistics once, in place
    torch.testing.assert_close(rm, 0.1 * mean.detach())
    assert (tbn.batch_norm_fwd.launches,
            tbn.batch_norm_bwd.launches) == before


def test_other_axes_on_the_cpu_match_the_last_axis():
    """axis=1 moves the channels last around the same op."""
    x, (gamma, beta, mm, mv) = _inputs((4, 6, 3, 5), 1, seed=9)
    args = [torch.from_numpy(a) for a in (gamma, beta, mm, mv)]
    t = torch.from_numpy(x)
    got = tnn.batch_norm(t, *args, eps=1e-5, fix_gamma=False, axis=1)[0]
    want = tnn.batch_norm(t.movedim(1, -1).contiguous(), *args, eps=1e-5,
                          fix_gamma=False, axis=-1)[0].movedim(-1, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# K6b at every BatchNorm shape of ResNet-50 at batch 128 (M = N*H*W, C, the
# BatchNorms of a step) in bf16: the route launch_plan takes
RESNET_BWD = [
    (1605632, 64, 1, "streamed"), (401408, 64, 6, "streamed"),
    (401408, 256, 4, "streamed"), (100352, 128, 8, "streamed"),
    (100352, 512, 5, "streamed"), (25088, 256, 12, "resident"),
    (25088, 1024, 7, "streamed"), (6272, 512, 6, "resident"),
    (6272, 2048, 4, "streamed"),
]


@pytest.mark.parametrize("m,c,per_step,route", RESNET_BWD)
def test_bwd_launch_plan_at_resnet_shapes(m, c, per_step, route):
    """K6b's one launch: its route, a grid no larger than the blocks it
    assumes co-resident on the 132 SMs, the forward's row partition (so
    the same partial sums and workspace), and for "resident" slabs that
    hold each block's rows of x and dy within the shared memory of a
    block and of an SM."""
    plan = tbn.launch_plan(m, c, torch.bfloat16)
    assert plan.route == route
    assert plan.bwd_grid <= 132 * plan.blocks_per_sm
    assert plan.bwd_ws == 2 * c * plan.splits + 3 * c
    rps = -(-plan.rows // plan.rows_at_once)  # rounds a split
    if route == "resident":
        spb = plan.splits_per_block
        static = 2 * tbn.THREADS * plan.vec * 4  # the block's sums
        assert plan.bwd_grid == -(-plan.splits // spb) * plan.channel_tiles
        assert plan.rounds == plan.kept_rounds == spb * rps
        assert plan.bwd_smem == plan.rounds * tbn.THREADS * 2 * 16
        assert plan.bwd_smem >= spb * plan.rows * plan.tile_c * 2 * 2
        assert plan.bwd_smem + static <= tbn.SMEM_PER_BLOCK
        assert plan.blocks_per_sm * (plan.bwd_smem + static
                                     + tbn.SMEM_RESERVED) <= tbn.SMEM_PER_SM
        # the fewest splits a block that fit: one fewer does not
        if spb > 1:
            fewer = tbn._resident_blocks_per_sm((spb - 1) * rps, plan.vec)
            assert -(-plan.splits // (spb - 1)) * plan.channel_tiles \
                > 132 * fewer
        # x and dy of the whole tensor lie in the card's shared memory
        assert 2 * 2 * m * c <= 132 * tbn.SMEM_PER_SM
    else:
        assert plan.blocks_per_sm == 4
        assert plan.splits_per_block == 1 and plan.rounds == rps
        assert plan.bwd_grid == plan.splits * plan.channel_tiles <= 4 * 132
        # one item a block: the first 5 rounds of its rows stay on the
        # chip, in the shared memory that 4 blocks an SM leave
        assert plan.kept_rounds == 5
        assert plan.bwd_smem == 5 * tbn.THREADS * 2 * 16
        assert 4 * (plan.bwd_smem + 2 * tbn.THREADS * plan.vec * 4
                    + tbn.SMEM_RESERVED) <= tbn.SMEM_PER_SM


@pytest.mark.parametrize("m,c,dtype,aligned,route", [
    (6272, 512, torch.float32, True, "resident"),
    (25088, 256, torch.float32, True, "streamed"),   # 51 MB of x and dy
    (1605632, 64, torch.float16, True, "streamed"),
    (3, 64, torch.bfloat16, True, "resident"),
    (792, 5, torch.bfloat16, True, "streamed"),      # scalar access
    (6272, 512, torch.bfloat16, False, "streamed"),  # a misaligned pointer
])
def test_bwd_route_by_type_and_access(m, c, dtype, aligned, route):
    """cp.async copies 16 bytes, so a scalar access streams; float32's
    slab is twice bf16's."""
    plan = tbn.launch_plan(m, c, dtype, aligned)
    assert plan.route == route
    assert plan.bwd_grid <= 132 * plan.blocks_per_sm
    if plan.vec == 1:  # nothing on the chip without cp.async
        assert plan.kept_rounds == plan.bwd_smem == 0


@pytest.mark.parametrize("m,c,per_step,route", RESNET_BWD)
def test_bwd_plan_fits_a_card_of_fewer_sms(m, c, per_step, route):
    """On a card of 114 SMs the row partition, and so K6b's sums, stay
    those of the 132-SM plan; only the route and grid adapt, every block
    still co-resident."""
    plan = tbn.launch_plan(m, c, torch.bfloat16)
    small = tbn.launch_plan(m, c, torch.bfloat16, True, 114)
    assert small[:10] == plan[:10]  # the forward's geometry and workspaces
    assert small.bwd_grid <= 114 * small.blocks_per_sm
    if small.route == "streamed" and small.kept_rounds:
        assert small.bwd_grid == small.splits * small.channel_tiles


def test_bwd_plan_is_held_to_the_occupancy_api(monkeypatch):
    """Each (device, type, access, route, shared memory) is asked of the
    occupancy API once; a plan of more blocks an SM than it allows
    raises before any launch."""
    class Lib:
        def __init__(self, blocks):
            self.blocks, self.asked = blocks, []

        def mxt_bn_bwd_occupancy(self, code, vec, resident, smem, out):
            self.asked.append((code, vec, resident, smem))
            out._obj.value = self.blocks
            return 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tbn, "_held", set())
    plan = tbn.launch_plan(25088, 256, torch.bfloat16)
    assert plan.route == "resident"
    lib = Lib(plan.blocks_per_sm)
    for _ in range(2):
        tbn._hold_to_occupancy(lib, plan.bwd_occupancy(1),
                               torch.device("cuda", 0))
    assert lib.asked == [(1, 8, 1, plan.bwd_smem)]
    few = Lib(plan.blocks_per_sm - 1)
    with pytest.raises(tmx_error, match="occupancy API allows 1"):
        tbn._hold_to_occupancy(few, plan.bwd_occupancy(1),
                               torch.device("cuda", 1))


@pytest.mark.parametrize("m,c", [(25088, 256), (6272, 2048), (792, 5)])
def test_bwd_launches_the_plan(monkeypatch, m, c):
    """batch_norm_bwd hands mxt_bn_bwd the geometry and the route, grid,
    shared memory, splits a block and rounds kept of launch_plan's plan,
    after holding the plan to the occupancy API (shapes only: meta
    tensors, the library and the launch replaced)."""
    seen = {}

    class Kernels:
        @staticmethod
        def library(name):
            return type("Lib", (), {"mxt_bn_bwd": "mxt_bn_bwd"})

        @staticmethod
        def launch(lib, fn, *args):
            seen.update(fn=fn, args=args)

    monkeypatch.setattr(tbn, "_kernels", Kernels)
    monkeypatch.setattr(tbn, "_hold_to_occupancy",
                        lambda lib, occ, dev: seen.update(held=occ))
    x = torch.empty(m, c, dtype=torch.bfloat16, device="meta")
    g = torch.empty(c, dtype=torch.bfloat16, device="meta")
    stats = torch.empty(4, c, device="meta")
    tbn.batch_norm_bwd(x, torch.empty_like(x), stats, g, g, False, True)
    plan = tbn.launch_plan(m, c, torch.bfloat16)
    assert seen["held"] == plan.bwd_occupancy(1)
    assert seen["fn"] == "mxt_bn_bwd"
    assert seen["args"][7].numel() == plan.bwd_ws
    assert seen["args"][8:] == (
        m, c, plan.vec, plan.tpr, plan.splits, plan.rows, 1, 1, 1, 1, 0,
        int(plan.route == "resident"), plan.bwd_grid, plan.bwd_smem,
        plan.splits_per_block, plan.kept_rounds)


# K6a at the same shapes in bf16, streamed at each: the BatchNorms of a
# step and the rounds a thread keeps of x (all of a split's rows at
# (25088, 256) and (6272, 512))
RESNET_FWD = [
    (1605632, 64, 1, 10), (401408, 64, 6, 10), (401408, 256, 4, 10),
    (100352, 128, 8, 10), (100352, 512, 5, 10), (25088, 256, 12, 6),
    (25088, 1024, 7, 10), (6272, 512, 6, 3), (6272, 2048, 4, 10),
]


def test_resnet_shapes_are_the_batchnorms_of_a_step():
    """The 9 shapes cover the 53 BatchNorms of a ResNet-50 step, each
    listed with its count in both tables."""
    assert sum(n for _, _, n, _ in RESNET_FWD) == 53
    assert [r[:3] for r in RESNET_FWD] == [r[:3] for r in RESNET_BWD]


@pytest.mark.parametrize("m,c,per_step,kept", RESNET_FWD)
def test_fwd_launch_plan_at_resnet_shapes(m, c, per_step, kept):
    """K6a's one launch, streamed: one item a block, at most four blocks
    an SM on the 132 SMs, the row partition of K6b (the same workspace),
    and each thread's first rounds of x, at most 10, kept in the shared
    memory that four blocks an SM leave beside their two float32 sums a
    channel."""
    plan = tbn.launch_plan(m, c, torch.bfloat16)
    assert plan.fwd_ws == 2 * c * plan.splits
    rps = -(-plan.rows // plan.rows_at_once)  # rounds a split
    static = 2 * tbn.THREADS * plan.vec * 4   # the block's sums
    assert plan.fwd_blocks_per_sm == 4
    assert plan.fwd_grid == plan.splits * plan.channel_tiles <= 4 * 132
    assert plan.fwd_kept_rounds == kept == min(10, rps)
    assert plan.fwd_smem == kept * tbn.THREADS * 16
    assert 4 * (plan.fwd_smem + static + tbn.SMEM_RESERVED) \
        <= tbn.SMEM_PER_SM
    assert 4 * (plan.fwd_smem + 16 * tbn.THREADS + static
                + tbn.SMEM_RESERVED) > tbn.SMEM_PER_SM or kept == rps


@pytest.mark.parametrize("m,c,dtype,aligned,kept", [
    (6272, 512, torch.float32, True, 6),
    (25088, 256, torch.float32, True, 12),
    (100352, 128, torch.float32, True, 13),  # one sum a channel
    (1605632, 64, torch.float16, True, 10),
    (6272, 2048, torch.float16, True, 10),
    (3, 64, torch.bfloat16, True, 1),
    (792, 5, torch.bfloat16, True, 0),       # scalar access
    (792, 5, torch.float32, True, 0),
    (6272, 512, torch.bfloat16, False, 0),   # a misaligned pointer
])
def test_fwd_route_by_type_and_access(m, c, dtype, aligned, kept):
    """K6a streams at every shape.  cp.async copies 16 bytes, so a scalar
    access keeps nothing; float32's rounds are twice bf16's bytes a row,
    but its block sums one float a channel, so a block keeps up to 13
    rounds where bf16 keeps 10."""
    plan = tbn.launch_plan(m, c, dtype, aligned)
    assert plan.fwd_kept_rounds == kept
    assert plan.fwd_blocks_per_sm == 4
    assert plan.fwd_grid <= 132 * plan.fwd_blocks_per_sm
    assert plan.fwd_smem == kept * tbn.THREADS * 16


@pytest.mark.parametrize("m,c,per_step,kept", RESNET_FWD)
def test_fwd_plan_fits_a_card_of_fewer_sms(m, c, per_step, kept):
    """On a card of 114 SMs the row partition, and so K6a's sums, stay
    those of the 132-SM plan; only the grid adapts, every block still
    co-resident, and blocks that walk more than one item keep nothing."""
    plan = tbn.launch_plan(m, c, torch.bfloat16)
    small = tbn.launch_plan(m, c, torch.bfloat16, True, 114)
    assert small[:10] == plan[:10]  # the geometry and the workspaces
    assert small.fwd_grid == min(small.splits * small.channel_tiles,
                                 4 * 114)
    if small.fwd_grid < small.splits * small.channel_tiles:
        assert small.fwd_kept_rounds == small.fwd_smem == 0


def test_fwd_plan_is_held_to_the_occupancy_api(monkeypatch):
    """K6a's plan is asked of mxt_bn_fwd_occupancy once for each
    (device, type, access, shared memory), apart from K6b's; a plan of
    more blocks an SM than it allows raises."""
    class Lib:
        def __init__(self, blocks):
            self.blocks, self.asked = blocks, []

        def mxt_bn_fwd_occupancy(self, code, vec, smem, out):
            self.asked.append(("fwd", code, vec, smem))
            out._obj.value = self.blocks
            return 0

        def mxt_bn_bwd_occupancy(self, code, vec, resident, smem, out):
            self.asked.append(("bwd", code, vec, resident, smem))
            out._obj.value = self.blocks
            return 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tbn, "_held", set())
    plan = tbn.launch_plan(6272, 2048, torch.bfloat16)
    lib = Lib(4)
    for _ in range(2):
        tbn._hold_to_occupancy(lib, plan.fwd_occupancy(1),
                               torch.device("cuda", 0))
        tbn._hold_to_occupancy(lib, plan.bwd_occupancy(1),
                               torch.device("cuda", 0))
    assert lib.asked == [("fwd", 1, 8, plan.fwd_smem),
                         ("bwd", 1, 8, 0, plan.bwd_smem)]
    few = Lib(plan.fwd_blocks_per_sm - 1)
    with pytest.raises(tmx_error, match="the plan puts 4 blocks an SM of "
                                        "the kernel that mxt_bn_fwd_occupancy"
                                        " answers for.*allows 3"):
        tbn._hold_to_occupancy(few, plan.fwd_occupancy(1),
                               torch.device("cuda", 1))


@pytest.mark.parametrize("m,c,dtype", [
    (100352, 128, torch.bfloat16), (1605632, 64, torch.bfloat16),
    (6272, 512, torch.float32), (792, 5, torch.bfloat16)])
@pytest.mark.parametrize("mode", ["train", "momentum", "predict"])
def test_fwd_launches_the_plan(monkeypatch, m, c, dtype, mode):
    """K6a's launch (batch_norm_fwd on a CUDA tensor) hands mxt_bn_fwd the
    geometry and the forward grid, shared memory and rounds kept of
    launch_plan's plan, after holding the plan to the occupancy API, and
    counts one launch a call (shapes only: meta tensors, the library and
    the launch replaced)."""
    seen = []

    class Kernels:
        @staticmethod
        def library(name):
            return type("Lib", (), {"mxt_bn_fwd": "mxt_bn_fwd"})

        @staticmethod
        def launch(lib, fn, *args):
            seen.append((fn, args))

    held = []
    monkeypatch.setattr(tbn, "_kernels", Kernels)
    monkeypatch.setattr(tbn, "_hold_to_occupancy",
                        lambda lib, occ, dev: held.append(occ))
    x = torch.empty(m, c, dtype=dtype, device="meta")
    g = torch.empty(c, dtype=dtype, device="meta")
    rm = torch.empty(c, device="meta")
    before = tbn.batch_norm_fwd.launches
    for _ in range(2):
        y, mean, var, stats = tbn._launch_fwd(
            x, g, g, rm, rm, 1e-5, False, mode == "predict",
            0.9 if mode == "momentum" else None)
    assert tbn.batch_norm_fwd.launches == before + 2
    assert y.shape == x.shape and stats.shape == (4, c)
    plan = tbn.launch_plan(m, c, dtype)
    code = tbn._DTYPE_CODES[dtype]
    assert held == [plan.fwd_occupancy(code)] * 2
    want_mode = {"train": 0, "momentum": 1, "predict": 2}[mode]
    mom = 0.9 if mode == "momentum" else 0.0
    for fn, args in seen:
        assert fn == "mxt_bn_fwd"
        ws = args[9]
        assert ws.numel() == (1 if mode == "predict" else plan.fwd_ws)
        assert args[10:21] == (m, c, plan.vec, plan.tpr, plan.splits,
                               plan.rows, code, code, code, want_mode, 0)
        assert args[21] == 1e-5 and args[22] == mom
        assert args[23] == pytest.approx(1.0 - mom)
        assert args[24:] == (plan.fwd_grid, plan.fwd_smem,
                             plan.fwd_kept_rounds)
