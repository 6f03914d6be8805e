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
- forwards: 1e-6 for max (both pick one of the inputs) and 1e-5 for
  avg and sum (float32 sums in another order).
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
    with pytest.raises(MXNetError, match="NHWC"):
        tgnn.MaxPool2D(2)
    with pytest.raises(ValueError, match="pool_type"):
        tnn.pooling(x, kernel=(2, 2), pool_type="lp", layout="NHWC")
    dy = torch.zeros(1, 2, 2, 2)
    with pytest.raises(MXNetError, match="255 taps"):
        pb.maxpool_bwd(x, dy, (16, 16), (1, 1))
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        pb.maxpool_bwd(x.half(), dy.half(), (2, 2), (2, 2))
    with pytest.raises(MXNetError, match="does not match"):
        pb.maxpool_bwd(x, torch.zeros(1, 2, 2, 3), (2, 2), (2, 2))
