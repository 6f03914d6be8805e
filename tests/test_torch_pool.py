"""The port's pooling (mxnet_tpu_torch/ops/nn.py pooling) and the max-pool
input-gradient (ops/pool_bwd.py, kernel K2) against the JAX package, on
the CPU, where the wrapper takes its plain version.

Tolerances:
- max-pool dX, float32: 1e-6 (rtol and atol): a pixel sums the dy of at
  most four windows, in window order in the port and in tap order in the
  Pallas kernel;
- max-pool dX, bf16 dy at 3x3/s2: two bf16 steps (2**-7 of the value):
  the port sums a pixel's (at most four) windows in float32 and rounds
  once, the Pallas kernel rounds after each bf16 addition;
- which pixels receive a gradient is compared exactly, for all-ties
  windows too; where the real taps of a window are all -inf, the values
  too;
- max-pool dX, float16 dy at 3x3/s2: two float16 steps (2**-9 of the
  value), for the same reason as bf16;
- forwards: 1e-6 for max (both pick one of the inputs) and 1e-5 for
  avg and sum (float32 sums in another order);
- the host-side model of K2's tiling (launch_plan, tile_geometry, and the
  kernel's three phases written out tile by tile) equals the plain
  version bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.pallas_pool import maxpool_bwd_nhwc
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import pool_bwd as pb

# (N, H, W, C), kernel, stride, pad: tests/test_pallas_pool.py's CASES and
# an odd shape with a one-channel-wide edge
CASES = [
    ((2, 8, 8, 16), (3, 3), (2, 2), (1, 1)),   # the ResNet stem pool
    ((2, 8, 8, 16), (2, 2), (2, 2), (0, 0)),
    ((1, 9, 9, 8), (3, 3), (2, 2), (1, 1)),
    ((2, 8, 8, 8), (3, 3), (1, 1), (1, 1)),    # overlapping windows
    ((3, 9, 11, 5), (3, 3), (2, 2), (1, 1)),
]


def _out(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def _dy_shape(xs, k, s, p):
    n, h, w, c = xs
    return (n, _out(h, k[0], s[0], p[0]), _out(w, k[1], s[1], p[1]), c)


def _pallas(x, dy, k, s, p):
    return np.asarray(maxpool_bwd_nhwc(jnp.asarray(x), jnp.asarray(dy), k, s,
                                       p, interpret=True))


@pytest.mark.parametrize("xs,k,s,p", CASES)
def test_plain_bwd_matches_pallas(xs, k, s, p):
    rs = np.random.RandomState(0)
    x = rs.rand(*xs).astype(np.float32)
    dy = rs.rand(*_dy_shape(xs, k, s, p)).astype(np.float32)
    got = pb.maxpool_bwd(torch.from_numpy(x), torch.from_numpy(dy), k, s, p)
    np.testing.assert_allclose(got.numpy(), _pallas(x, dy, k, s, p),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,s,p", [((2, 2), (2, 2), (0, 0)),
                                   ((3, 3), (1, 1), (1, 1)),
                                   ((3, 3), (2, 2), (1, 1))])
def test_all_ties_route_as_pallas(k, s, p):
    """A constant input: the tie rule alone decides every window."""
    rs = np.random.RandomState(1)
    x = np.ones((1, 6, 6, 8), np.float32)
    dy = rs.rand(*_dy_shape(x.shape, k, s, p)).astype(np.float32)
    got = pb.maxpool_bwd(torch.from_numpy(x), torch.from_numpy(dy), k, s,
                         p).numpy()
    want = _pallas(x, dy, k, s, p)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_windows_of_minus_inf_give_their_dy_to_no_pixel():
    """Where a window's real taps are all -inf, its first argmax is a
    padded tap: the Pallas kernel sends dy into the padding it slices
    away, and the port drops it."""
    rs = np.random.RandomState(2)
    x = rs.rand(1, 6, 6, 8).astype(np.float32)
    x[:, :2, :2] = -np.inf
    dy = rs.rand(1, 3, 3, 8).astype(np.float32)
    got = pb.maxpool_bwd(torch.from_numpy(x), torch.from_numpy(dy), (3, 3),
                         (2, 2), (1, 1))
    want = _pallas(x, dy, (3, 3), (2, 2), (1, 1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(np.abs(want[:, :2, :2]).max()) == 0.0


def test_bf16_dy_within_two_bf16_steps_of_pallas():
    rs = np.random.RandomState(3)
    xs, k, s, p = (2, 9, 9, 16), (3, 3), (2, 2), (1, 1)
    x = rs.rand(*xs).astype(np.float32)
    x[0] = 0.5  # ties: some pixels win several windows
    dy = rs.rand(*_dy_shape(xs, k, s, p)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    dyb = torch.from_numpy(dy).bfloat16()
    got = pb.maxpool_bwd(xb, dyb, k, s, p)
    assert got.dtype == torch.bfloat16
    want = np.asarray(maxpool_bwd_nhwc(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(dyb.float().numpy()).astype(jnp.bfloat16), k, s, p,
        interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=0)


def test_plain_bwd_sums_in_float32_and_rounds_once():
    """A bf16 pixel wins three windows with dy 1, 2**-8 and 2**-8: bf16
    additions would round 1 + 2**-8 back to 1 twice, the float32 sum
    1 + 2**-7 is a bf16 value."""
    x = torch.tensor([0.0, 1.0, 0.0, 0.0, 0.0]).reshape(1, 1, 5, 1)
    dy = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -8, 0.5, 0.25])
    got = pb.maxpool_bwd(x.bfloat16(), dy.reshape(1, 1, 5, 1).bfloat16(),
                         (1, 3), (1, 1), (0, 1))
    # window 3 is all ties (pixel 2), window 4's first tap is pixel 3
    assert got.flatten().tolist() == [0.0, 1 + 2.0 ** -7, 0.5, 0.25, 0.0]


@pytest.mark.parametrize("xs,k,s,p", CASES[:4])
def test_max_pooling_forward_and_grad_match_jax(xs, k, s, p):
    rs = np.random.RandomState(4)
    x = rs.normal(size=xs).astype(np.float32)
    x[0, 0] = 1.0  # a row of ties

    def jfn(x_):
        return jnn.pooling(x_, kernel=k, pool_type="max", stride=s, pad=p,
                           layout="NHWC")

    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    dy = rs.normal(size=want.shape).astype(np.float32)
    (wdx,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    got = tnn.pooling(tx, kernel=k, pool_type="max", stride=s, pad=p,
                      layout="NHWC")
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wdx), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
@pytest.mark.parametrize("convention", ["valid", "full"])
@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("xs,k,s,p", [((2, 7, 7, 4), (3, 3), (2, 2), (1, 1)),
                                      ((1, 5, 6, 3), (2, 2), (3, 3), (0, 0)),
                                      ((1, 4, 4, 2), (2, 2), (3, 3), (1, 1))])
def test_pooling_forward_matches_jax(pool_type, convention,
                                     count_include_pad, xs, k, s, p):
    """The last shape's ``full`` convention gives a window that lies in
    the padding alone: its count is 0 and avg gives 0, never NaN."""
    x = np.random.RandomState(5).normal(size=xs).astype(np.float32)
    kw = dict(kernel=k, pool_type=pool_type, stride=s, pad=p,
              pooling_convention=convention,
              count_include_pad=count_include_pad, layout="NHWC")
    want = np.asarray(jnn.pooling(jnp.asarray(x), **kw))
    got = tnn.pooling(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape and np.isfinite(got).all() == \
        np.isfinite(want).all()
    tol = 1e-6 if pool_type == "max" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_avg_pool_matches_jax_layer(dtype):
    from mxnet_tpu import nd
    from mxnet_tpu.gluon import nn as jgnn

    x = np.random.RandomState(6).normal(size=(2, 7, 5, 8)).astype(np.float32)
    want = jgnn.GlobalAvgPool2D(layout="NHWC")(
        nd.array(x).astype(dtype)).astype("float32").asnumpy()
    got = tgnn.GlobalAvgPool2D(layout="NHWC")(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape == (2, 1, 1, 8) and str(got.dtype) == "torch." + dtype
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_max_pool_layer_matches_jax_layer():
    from mxnet_tpu import nd
    from mxnet_tpu.gluon import nn as jgnn

    x = np.random.RandomState(7).normal(size=(2, 9, 9, 4)).astype(np.float32)
    for kw in ({}, {"ceil_mode": True}):
        jl = jgnn.MaxPool2D(3, 2, 1, layout="NHWC", **kw)
        tl = tgnn.MaxPool2D(3, 2, 1, layout="NHWC", **kw)
        np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(),
                                   jl(nd.array(x)).asnumpy(), rtol=1e-6,
                                   atol=1e-6)


def test_what_the_port_does_not_take_raises():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(MXNetError, match="NHWC"):
        tnn.pooling(x, kernel=(2, 2), layout="NCHW")
    with pytest.raises(ValueError, match="pool_type"):  # lp is ported
        tnn.pooling(x, kernel=(2, 2), pool_type="median", layout="NHWC")
    dy = torch.zeros(1, 2, 2, 2)
    with pytest.raises(MXNetError, match="255 taps"):
        pb.maxpool_bwd(x, dy, (16, 16), (1, 1))
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        pb.maxpool_bwd(x.double(), dy.double(), (2, 2), (2, 2))
    with pytest.raises(MXNetError, match="does not match"):
        pb.maxpool_bwd(x, torch.zeros(1, 2, 2, 3), (2, 2), (2, 2))


@pytest.mark.parametrize("xs,k,s,p", [CASES[0], CASES[3]])
def test_float16_dy_within_two_float16_steps_of_pallas(xs, k, s, p):
    """float16 x and dy, as the JAX package's float16 gradient runs them:
    the Pallas kernel in interpret mode."""
    rs = np.random.RandomState(8)
    x = rs.rand(*xs).astype(np.float32)
    x[0, :, :2] = 0.5  # ties
    dy = rs.rand(*_dy_shape(xs, k, s, p)).astype(np.float32)
    xh, dyh = torch.from_numpy(x).half(), torch.from_numpy(dy).half()
    got = pb.maxpool_bwd(xh, dyh, k, s, p)
    assert got.dtype == torch.float16
    want = np.asarray(maxpool_bwd_nhwc(
        jnp.asarray(x, dtype=jnp.float16), jnp.asarray(dy, dtype=jnp.float16),
        k, s, p, interpret=True).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy() != 0, want != 0)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -9,
                               atol=0)


def test_float16_max_pooling_grad_matches_jax_grad():
    """The float16 gradient of the port's max pool against jax.grad of the
    JAX package's float16 Pooling (XLA's select-and-scatter, which also
    adds in float16)."""
    rs = np.random.RandomState(9)
    x = rs.normal(size=(2, 9, 9, 8)).astype(np.float16)
    dy = rs.rand(2, 5, 5, 8).astype(np.float16)

    def jfn(x_):
        return jnn.pooling(x_, kernel=(3, 3), pool_type="max",
                           stride=(2, 2), pad=(1, 1), layout="NHWC")

    _, vjp = jax.vjp(jfn, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tnn.pooling(tx, kernel=(3, 3), pool_type="max", stride=(2, 2),
                pad=(1, 1), layout="NHWC").backward(torch.from_numpy(dy))
    assert tx.grad.dtype == torch.float16
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=2.0 ** -9, atol=0)


# K2's tiling over a sweep of shapes: (x shape, kernel, stride, pad, dtype,
# whether the pointers are 16-byte aligned); the first is the main path's
PLAN_CASES = [
    ((128, 112, 112, 64), (3, 3), (2, 2), (1, 1), torch.bfloat16, True),
    ((128, 112, 112, 64), (3, 3), (2, 2), (1, 1), torch.float32, True),
    ((128, 112, 112, 64), (3, 3), (2, 2), (1, 1), torch.float16, True),
    ((3, 9, 11, 5), (3, 3), (2, 2), (1, 1), torch.bfloat16, True),
    ((2, 20, 18, 16), (2, 2), (2, 2), (0, 0), torch.bfloat16, True),
    ((2, 21, 19, 24), (3, 3), (1, 1), (1, 1), torch.bfloat16, True),
    ((32, 56, 56, 64), (3, 3), (1, 1), (1, 1), torch.bfloat16, True),
    ((1, 20, 23, 8), (7, 7), (1, 1), (3, 3), torch.float32, True),
    ((2, 23, 20, 16), (7, 7), (3, 3), (0, 0), torch.float16, True),
    ((1, 11, 13, 8), (1, 1), (2, 2), (0, 0), torch.bfloat16, True),
    ((1, 13, 17, 8), (2, 5), (3, 1), (1, 2), torch.bfloat16, True),
    ((1, 4, 4, 8), (2, 2), (2, 2), (2, 2), torch.float16, True),
    ((2, 16, 16, 64), (3, 3), (2, 2), (1, 1), torch.bfloat16, False),
    ((1, 3, 260, 4), (1, 255), (1, 1), (0, 0), torch.float32, True),
    ((1, 20, 20, 8), (15, 17), (1, 1), (7, 8), torch.bfloat16, True),
    ((1, 10, 10, 72), (3, 3), (2, 2), (1, 1), torch.bfloat16, True),
]


def _covering(pos, k, s, p, out):
    """The windows along one axis whose taps cover input position pos."""
    return [o for o in range(out) if o * s - p <= pos < o * s - p + k]


def _plan_and_shapes(xs, k, s, p, dt, aligned):
    dys = _dy_shape(xs, k, s, p)
    return pb.launch_plan(xs, dys, k, s, dt, aligned), dys


def _image_tiles(plan, xs, dys, k, s, p):
    per_image = plan.tiles_h * plan.tiles_w * plan.chunks
    return per_image, [pb.tile_geometry(plan, xs, dys, k, s, p, b)
                       for b in range(per_image)]


@pytest.mark.parametrize("xs,k,s,p,dt,aligned", PLAN_CASES)
def test_launch_plan_owns_every_dx_element_once(xs, k, s, p, dt, aligned):
    """The tiles of one image cover its (H, W, C) exactly once, and tile
    t + i * (tiles an image) is the same tile of image i."""
    plan, dys = _plan_and_shapes(xs, k, s, p, dt, aligned)
    n, h, w, c = xs
    assert plan.tiles(n) == n * plan.tiles_h * plan.tiles_w * plan.chunks
    per_image, tiles = _image_tiles(plan, xs, dys, k, s, p)
    owned = np.zeros((h, w, c), np.int32)
    for t in tiles:
        assert t["n"] == 0
        owned[slice(*t["rows"]), slice(*t["cols"]), slice(*t["channels"])] += 1
    assert (owned == 1).all()
    for i in (1, n - 1):
        t = pb.tile_geometry(plan, xs, dys, k, s, p, i * per_image + 3 %
                             per_image)
        assert t["n"] == i and t["rows"] == tiles[3 % per_image]["rows"]
    if plan.access == "16-byte":
        assert plan.vec == 128 // torch.finfo(dt).bits \
            and c % plan.vec == 0 and plan.tile_c % plan.vec == 0 and aligned
    else:
        assert plan.vec == 1


@pytest.mark.parametrize("xs,k,s,p,dt,aligned", PLAN_CASES)
def test_launch_plan_halo_holds_every_covering_window(xs, k, s, p, dt,
                                                      aligned):
    """Every window that covers a pixel of a tile is in the tile's window
    range, every tap of those windows in its halo, and the halo and the
    windows fit the plan's bounds, which fit the shared-memory budget."""
    plan, dys = _plan_and_shapes(xs, k, s, p, dt, aligned)
    assert plan.smem_bytes <= pb.SMEM_BUDGET
    _, tiles = _image_tiles(plan, xs, dys, k, s, p)
    for t in tiles:
        for axis, (tile, win, halo, most_win, most_halo) in enumerate((
                (t["rows"], t["windows_h"], t["halo_rows"], plan.windows_h,
                 plan.halo_h),
                (t["cols"], t["windows_w"], t["halo_cols"], plan.windows_w,
                 plan.halo_w))):
            out = dys[1 + axis]
            need = {o for pos in range(*tile)
                    for o in _covering(pos, k[axis], s[axis], p[axis], out)}
            assert need <= set(range(*win))
            assert win[1] - win[0] <= most_win
            assert halo[1] - halo[0] <= most_halo
            for o in range(*win):
                lo = o * s[axis] - p[axis]
                assert halo[0] <= lo and lo + k[axis] <= halo[1]


def _tiled_model(x, dy, k, s, p, plan):
    """K2's phases, tile by tile, from what a block stages for a tile
    alone: the halo of x (-inf outside the image) and its windows' dy."""
    n, h, w, c = x.shape
    dys = tuple(dy.shape)
    dx = torch.full(x.shape, float("nan"), dtype=x.dtype)
    for b in range(plan.tiles(n)):
        t = pb.tile_geometry(plan, tuple(x.shape), dys, k, s, p, b)
        (h0, h1), (w0, w1), (c0, c1) = t["rows"], t["cols"], t["channels"]
        (oy0, oy1), (ox0, ox1) = t["windows_h"], t["windows_w"]
        (y0, y1), (x0, x1) = t["halo_rows"], t["halo_cols"]
        halo = torch.full((max(y1 - y0, 0), max(x1 - x0, 0), c1 - c0),
                          float("-inf"))
        ys, xs_ = slice(max(y0, 0), min(y1, h)), slice(max(x0, 0), min(x1, w))
        if halo.numel():
            halo[ys.start - y0:ys.stop - y0, xs_.start - x0:xs_.stop - x0] = \
                x[t["n"], ys, xs_, c0:c1].float()
        arg = {}
        for oy in range(oy0, oy1):
            for ox in range(ox0, ox1):
                m = best = None
                for tap in range(k[0] * k[1]):
                    r, q = divmod(tap, k[1])
                    v = halo[(oy - oy0) * s[0] + r, (ox - ox0) * s[1] + q]
                    if m is None:
                        m, best = v, torch.zeros(c1 - c0, dtype=torch.int64)
                    else:
                        take = v > m
                        m = torch.where(take, v, m)
                        best = torch.where(take, torch.full_like(best, tap),
                                           best)
                arg[oy, ox] = best
        for hh in range(h0, h1):
            for ww in range(w0, w1):
                acc = torch.zeros(c1 - c0)
                for oy in _covering(hh, k[0], s[0], p[0], dys[1]):
                    for ox in _covering(ww, k[1], s[1], p[1], dys[2]):
                        tap = (hh + p[0] - oy * s[0]) * k[1] \
                            + ww + p[1] - ox * s[1]
                        acc = acc + torch.where(
                            arg[oy, ox] == tap,
                            dy[t["n"], oy, ox, c0:c1].float(),
                            torch.zeros(()))
                dx[t["n"], hh, ww, c0:c1] = acc.to(x.dtype)
    return dx


@pytest.mark.parametrize("case", [c for c in PLAN_CASES
                                  if c[0][0] * c[0][1] * c[0][2] <= 4000
                                  and c[1][0] * c[1][1] <= 49])
def test_tiled_model_equals_plain_version_bitwise(case):
    """Each tile computed only from its own halo and windows gives the
    plain version's dX bit for bit, NaN inputs included."""
    xs, k, s, p, dt, aligned = case
    rs = np.random.RandomState(10)
    x = rs.normal(size=xs).astype(np.float32)
    x[:, ::3, ::2, ::5] = np.nan
    x[0, :1, :1] = -np.inf
    dy = rs.normal(size=_dy_shape(xs, k, s, p)).astype(np.float32)
    tx, tdy = torch.from_numpy(x).to(dt), torch.from_numpy(dy).to(dt)
    plan, _ = _plan_and_shapes(xs, k, s, p, dt, aligned)
    got = _tiled_model(tx, tdy, k, s, p, plan)
    want = pb.maxpool_bwd_reference(tx, tdy, k, s, p)
    assert torch.equal(got, want)
