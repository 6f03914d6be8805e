"""The port's convolution (mxnet_tpu_torch/ops/nn.py convolution) and its
weight-gradient (ops/conv_dw.py, kernels K1a/K1b) against the JAX package,
on the CPU, where the wrappers take their plain version.

Tolerances:
- dW, float32 inputs: 2e-4 (rtol and atol), as tests/test_pallas_conv.py
  holds the Pallas kernel to XLA's dW: sums of up to a few hundred float32
  products in another order;
- dW, bf16 and float16 inputs: 1e-3 of the largest magnitude: each
  product of two bf16 (or float16) values is exact in float32 in both
  packages, only the order of the float32 sums differs;
- the float16 convolution's gradients against jax.grad of the JAX
  package's float16 convolution: one float16 step (2**-10) of the largest
  magnitude, both rounded to float16 once;
- convolution forward, dX and the bias gradient: 1e-5 (rtol and atol),
  one float32 op each, summed in another order by each package;
- the emulated float32 tensor-core route (3xTF32): 1e-5 of the plain
  version's largest magnitude (float32 sums in another order; each
  product exact to about 2^-20), and against a float64 dW no more than 4x
  the float32 plain version's own error, the gate phase 3c holds the
  kernel to on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.pallas_conv import conv_dw_nhwc, conv_dw_xla
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
from mxnet_tpu_torch.ops import conv_dw as cdw
from mxnet_tpu_torch.ops import nn as tnn

# (N, H, W, I), kernel, stride, pad, O: tests/test_pallas_conv.py's CASES
CASES = [
    ((4, 8, 8, 16), (3, 3), (1, 1), (1, 1), 32),
    ((4, 8, 8, 16), (1, 1), (1, 1), (0, 0), 32),
    ((4, 9, 9, 8), (3, 3), (2, 2), (1, 1), 16),
    ((2, 8, 8, 8), (7, 7), (2, 2), (3, 3), 16),
    ((4, 8, 8, 8), (1, 1), (2, 2), (0, 0), 16),
]
TOL = dict(rtol=1e-5, atol=1e-5)


def _out(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def _inputs(xs, k, s, p, o, seed=0):
    rs = np.random.RandomState(seed)
    n, h, w, _ = xs
    x = rs.rand(*xs).astype(np.float32)
    dy = rs.rand(n, _out(h, k[0], s[0], p[0]), _out(w, k[1], s[1], p[1]),
                 o).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("xs,k,s,p,o", CASES)
@pytest.mark.parametrize("form", ["pertap", "im2col"])
def test_plain_dw_matches_pallas(xs, k, s, p, o, form):
    x, dy = _inputs(xs, k, s, p, o)
    want = conv_dw_nhwc(jnp.asarray(x), jnp.asarray(dy), k, s, p,
                        interpret=True, formulation=form)
    run = cdw.conv_dw_pertap if form == "pertap" else cdw.conv_dw_im2col
    got = run(torch.from_numpy(x), torch.from_numpy(dy), k, s, p)
    assert got.dtype == torch.float32 and got.shape == (o,) + k + xs[3:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_plain_dw_stem_matches_xla():
    """The ResNet stem's shape, I=3 7x7/s2/p3 with an odd input, which the
    JAX package's supported() sends to XLA; on the card it runs K1b."""
    x, dy = _inputs((2, 23, 21, 3), (7, 7), (2, 2), (3, 3), 16)
    want = conv_dw_xla(jnp.asarray(x), jnp.asarray(dy), (7, 7), (2, 2),
                       (3, 3))
    got = cdw.conv_dw(torch.from_numpy(x), torch.from_numpy(dy), (7, 7),
                      (2, 2), (3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("form", ["pertap", "im2col"])
def test_plain_dw_bf16_matches_pallas(form):
    x, dy = _inputs((4, 9, 9, 8), (3, 3), (2, 2), (1, 1), 16, seed=1)
    xb, dyb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dy))
    want = np.asarray(conv_dw_nhwc(xb, dyb, (3, 3), (2, 2), (1, 1),
                                   interpret=True, formulation=form))
    got = cdw.conv_dw(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(dy).bfloat16(), (3, 3), (2, 2),
                      (1, 1))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def test_formulation_rule():
    assert [cdw.formulation(i) for i in (3, 64, 127, 128, 2048)] == [
        "im2col", "im2col", "im2col", "pertap", "pertap"]


def _resnet50_convs(batch=128, size=224):
    """(x shape, kernel, stride, pad, O) of every convolution of
    resnet50_v1 at (batch, size, size, 3), in forward order."""
    net = resnet50_v1(layout="NHWC", device="meta")
    convs = []

    def hook(mod, args, out):
        convs.append((tuple(args[0].shape), mod._kwargs["kernel"],
                      mod._kwargs["stride"], mod._kwargs["pad"],
                      mod._kwargs["num_filter"]))

    for m in net.modules():
        if isinstance(m, tgnn.Conv2D):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.empty(batch, size, size, 3, device="meta"))
    return convs


RAGGED = ((8, 15, 13, 200), (3, 3), (2, 2), (1, 1), 100)


def _positions(xs, k, s, p):
    n, h, w, _ = xs
    return n * _out(h, k[0], s[0], p[0]) * _out(w, k[1], s[1], p[1])


def _tiles(plan, form, xs, k, o):
    """The kernel's blocks per split: row tiles x output-channel tiles
    (x taps for per-tap)."""
    rows = k[0] * k[1] * xs[3] if form == "im2col" else xs[3]
    tiles = -(-rows // cdw.TC_TILE_ROWS) * -(-o // plan.tile_o)
    return tiles * (k[0] * k[1] if form == "pertap" else 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet50_formulations_and_split_plan(dtype):
    """44 convolutions of ResNet-50 take K1a and 9 take K1b; each plan
    covers the reduction exactly once, in whole stages but the last (64
    positions for bf16, 32 for float32), and fills the card (one resident
    block per SM) at least 95 % of the 132 SMs, unless the smallest chunk
    stops it.  Both run on the tensor cores, bf16 on 16-bit wgmma and
    float32 by 3xTF32; the stem's x (I = 3) register-staged in bf16, by
    4-byte loads in float32."""
    convs = _resnet50_convs()
    forms = [cdw.formulation(xs[3]) for xs, *_ in convs]
    assert len(convs) == 53
    assert (forms.count("pertap"), forms.count("im2col")) == (44, 9)
    for (xs, k, s, p, o), form in zip(convs, forms):
        positions = _positions(xs, k, s, p)
        plan = cdw.launch_plan(form, k, s, p, xs, o, dtype)
        assert plan.entry == "mxt_conv_dw_" + form
        assert (plan.splits - 1) * plan.chunk < positions \
            <= plan.splits * plan.chunk, (xs, k, o)
        blocks = _tiles(plan, form, xs, k, o) * plan.splits
        f32 = dtype == torch.float32
        stage = cdw.TF32_STAGE if f32 else cdw.TC_STAGE
        assert plan.kernel == "tensor-core"
        assert plan.route == ("tf32x3" if f32 else "wgmma")
        assert plan.chunk % stage == 0
        assert blocks >= 0.95 * 132 or plan.chunk == 4 * stage, (xs, k, o)
        assert plan.tile_o == (64 if o <= 64 else 128)
        assert plan.dy_loads == "16-byte"
        assert plan.x_loads == ("16-byte" if xs[3] != 3 else
                                "4-byte" if f32 else "register-staged"), xs
        assert plan.ws_elems == (0 if plan.splits == 1 else
                                 plan.splits * o * k[0] * k[1] * xs[3])


@pytest.mark.parametrize("form", ["pertap", "im2col"])
def test_launch_plan_of_the_ragged_case_and_its_variant(form):
    """I = 200, O = 100: bf16 x by 16-byte copies, dy (200-byte rows)
    register-staged; the C variant packs dy, x and the 64-channel tile
    as bits 0, 1 and 2.  float32: both by 16-byte loads (O % 4 == 0), a
    tile of 128 channels in bits 2-6 as 128 / 8."""
    xs, k, s, p, o = RAGGED
    plan = cdw.launch_plan(form, k, s, p, xs, o, torch.bfloat16)
    assert (plan.x_loads, plan.dy_loads, plan.tile_o) == (
        "16-byte", "register-staged", 128)
    assert plan.variant == 2
    stem = cdw.launch_plan("im2col", (7, 7), (2, 2), (3, 3),
                           (128, 224, 224, 3), 64, torch.bfloat16)
    assert stem.variant == 1 | 4
    f32 = cdw.launch_plan(form, k, s, p, xs, o, torch.float32)
    assert (f32.route, f32.x_loads, f32.dy_loads, f32.tile_o) == (
        "tf32x3", "16-byte", "16-byte", 128)
    assert f32.variant == 1 | 2 | 16 << 2


@pytest.mark.parametrize("xs,k,s,p,o", [
    ((2, 40, 40, 3), (7, 7), (2, 2), (3, 3), 16),      # a shrunk stem
    ((4, 14, 14, 128), (3, 3), (1, 1), (1, 1), 32),    # a per-tap shape
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_k_partial_sums_in_split_order_make_dw(xs, k, s, p, o, dtype):
    """The plan's chunks, each summed by the plain version on its own
    positions and added in split order as the second pass does, give the
    whole dW within 1e-5 of its largest magnitude (only the float32
    order of the sums differs)."""
    form = cdw.formulation(xs[3])
    x, dy = _inputs(xs, k, s, p, o, seed=5)
    tx, tdy = (torch.from_numpy(a).to(dtype) for a in (x, dy))
    plan = cdw.launch_plan(form, k, s, p, xs, o, dtype)
    assert plan.splits > 1, "a shape the plan splits"
    n, h, w, _ = xs
    oh, ow = _out(h, k[0], s[0], p[0]), _out(w, k[1], s[1], p[1])
    # positions p = (n, y, x) in order; a chunk is a run of them, so the
    # plain version sums it as dy with every other position zeroed
    flat = tdy.reshape(n * oh * ow, o)
    total = torch.zeros((o,) + k + xs[3:])
    for sp in range(plan.splits):
        part = torch.zeros_like(flat)
        part[sp * plan.chunk:(sp + 1) * plan.chunk] = \
            flat[sp * plan.chunk:(sp + 1) * plan.chunk]
        total += cdw.conv_dw_reference(tx, part.reshape(tdy.shape), k, s, p)
    want = cdw.conv_dw_reference(tx, tdy, k, s, p)
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plan_small_reductions_are_not_cut_below_the_minimum(dtype):
    """100 positions stay one chunk of whole stages (4 of float32's 32, 2
    of bf16's 64); 10,000 positions on one tile are cut as finely as
    whole stages allow, not below four stages a chunk."""
    stage = cdw.TF32_STAGE if dtype == torch.float32 else cdw.TC_STAGE
    splits, chunk = cdw.split_plan("pertap", (1, 1), 128, 64, 100, dtype)
    assert (splits, chunk) == (1, 128)
    splits, chunk = cdw.split_plan("im2col", (3, 3), 3, 8, 10_000, dtype)
    assert chunk % stage == 0
    assert 4 * stage <= chunk < 8 * stage
    assert splits == -(-10_000 // chunk)


@pytest.mark.parametrize("xs,k,s,p,o", CASES[:4] + [
    ((2, 11, 10, 3), (7, 7), (2, 2), (3, 3), 8)])
@pytest.mark.parametrize("use_bias", [True, False])
def test_convolution_forward_and_grads_match_jax(xs, k, s, p, o, use_bias):
    rs = np.random.RandomState(2)
    x = rs.normal(size=xs).astype(np.float32)
    w = rs.normal(size=(o,) + k + xs[3:]).astype(np.float32)
    b = rs.normal(size=(o,)).astype(np.float32)

    def jfn(x_, w_, b_):
        return jnn.convolution(x_, w_, b_ if use_bias else None, kernel=k,
                               stride=s, pad=p, num_filter=o,
                               no_bias=not use_bias, layout="NHWC")

    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dy = rs.normal(size=want.shape).astype(np.float32)
    wdx, wdw, wdb = vjp(jnp.asarray(dy))

    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    got = tnn.convolution(tx, tw, tb if use_bias else None, kernel=k,
                          stride=s, pad=p, num_filter=o, layout="NHWC")
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(wdw), rtol=2e-4,
                               atol=2e-4)
    if use_bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(wdb), **TOL)
    else:
        assert tb.grad is None


def test_conv_dw_through_autograd_is_the_plain_dw_in_the_weights_dtype():
    x, dy = _inputs((2, 8, 8, 8), (3, 3), (1, 1), (1, 1), 16, seed=3)
    tx = torch.from_numpy(x).bfloat16()
    tw = torch.zeros(16, 3, 3, 8, dtype=torch.bfloat16, requires_grad=True)
    out = tnn.convolution(tx, tw, stride=1, pad=1, layout="NHWC")
    out.backward(torch.from_numpy(dy).bfloat16())
    want = cdw.conv_dw_reference(tx, torch.from_numpy(dy).bfloat16(), (3, 3),
                                 (1, 1), (1, 1)).bfloat16()
    assert tw.grad.dtype == torch.bfloat16
    assert torch.equal(tw.grad, want)


def test_conv2d_layer_matches_jax_layer():
    from mxnet_tpu import nd
    from mxnet_tpu.gluon import nn as jgnn

    rs = np.random.RandomState(4)
    x = rs.normal(size=(2, 9, 9, 5)).astype(np.float32)
    jl = jgnn.Conv2D(6, 3, strides=2, padding=1, in_channels=5,
                     layout="NHWC", activation="relu")
    jl.initialize()
    want = jl(nd.array(x)).asnumpy()
    tl = tgnn.Conv2D(6, 3, strides=2, padding=1, in_channels=5,
                     layout="NHWC", activation="relu", device="cpu")
    assert dict((k, tuple(v.shape)) for k, v in tl.state_dict().items()) == {
        "weight": (6, 3, 3, 5), "bias": (6,)}
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(jl.weight.data().asnumpy()))
        tl.bias.copy_(torch.from_numpy(jl.bias.data().asnumpy()))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               want, **TOL)


def test_what_the_port_does_not_take_raises():
    x, w = torch.zeros(1, 5, 5, 4), torch.zeros(8, 3, 3, 4)
    # groups that do not divide the widths (groups themselves run: see
    # tests/test_torch_conv_nd.py)
    with pytest.raises(MXNetError, match="groups"):
        tnn.convolution(x, torch.zeros(8, 3, 3, 2), num_group=3)
    with pytest.raises(MXNetError, match="NHWC"):
        tnn.convolution(x, w, layout="NCHW")
    with pytest.raises(MXNetError, match="kernel"):
        tnn.convolution(x, w, kernel=(1, 1))
    with pytest.raises(MXNetError, match="groups"):
        tgnn.Conv2D(8, 3, groups=3, in_channels=4, layout="NHWC",
                    device="cpu")
    with pytest.raises(ValueError, match="relu"):
        tnn.activation(x, act_type="bogus")
    dy = torch.zeros(1, 3, 3, 8)
    with pytest.raises(MXNetError, match="does not match"):
        cdw.conv_dw(x, dy, (3, 3), (1, 1), (1, 1))
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        cdw.conv_dw(x.double(), dy.double(), (3, 3))
    with pytest.raises(MXNetError, match="contiguous"):
        cdw.conv_dw(x.transpose(1, 2), dy, (3, 3))


@pytest.mark.parametrize("form", ["pertap", "im2col"])
def test_plain_dw_float16_matches_pallas(form):
    """float16 x and dy: the plain dW in float32 against the Pallas kernel
    in interpret mode; on the card the tensor-core kernel's f16 instances
    run (chip_smoke.py phase 3c)."""
    x, dy = _inputs((4, 9, 9, 8), (3, 3), (2, 2), (1, 1), 16, seed=5)
    xh, dyh = (jnp.asarray(a, dtype=jnp.float16) for a in (x, dy))
    want = np.asarray(conv_dw_nhwc(xh, dyh, (3, 3), (2, 2), (1, 1),
                                   interpret=True, formulation=form))
    run = cdw.conv_dw_pertap if form == "pertap" else cdw.conv_dw_im2col
    got = run(torch.from_numpy(x).half(), torch.from_numpy(dy).half(),
              (3, 3), (2, 2), (1, 1))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("xs,k,s,p,o", [CASES[0], CASES[2],
                                        ((2, 11, 10, 3), (7, 7), (2, 2),
                                         (3, 3), 8)])
def test_float16_convolution_grads_match_jax_grad(xs, k, s, p, o):
    """The backward of a float16 Convolution, which raised before the port
    took float16: dX and dW in float16 against jax.grad of the JAX
    package's float16 convolution."""
    rs = np.random.RandomState(6)
    x = rs.normal(size=xs).astype(np.float16)
    w = rs.normal(size=(o,) + k + xs[3:]).astype(np.float16)

    def jfn(x_, w_):
        return jnn.convolution(x_, w_, None, kernel=k, stride=s, pad=p,
                               num_filter=o, no_bias=True, layout="NHWC")

    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    dy = rs.normal(size=want.shape).astype(np.float16)
    wdx, wdw = vjp(jnp.asarray(dy))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = tnn.convolution(tx, tw, None, kernel=k, stride=s, pad=p,
                          num_filter=o, layout="NHWC")
    got.backward(torch.from_numpy(dy))
    assert tw.grad.dtype == tx.grad.dtype == torch.float16
    for g, want_g in ((tx.grad, wdx), (tw.grad, wdw)):
        want_g = np.asarray(want_g, np.float32)
        np.testing.assert_allclose(g.float().numpy(), want_g, rtol=0,
                                   atol=2.0 ** -10 * np.abs(want_g).max())


def test_float16_launch_plan_is_the_tensor_core_kernel():
    """float16 runs the bf16 plan: the tensor-core kernel, the same load
    paths, tiles and split-K partition."""
    for conv in ((128, 224, 224, 3), (7, 7), (2, 2), (3, 3), 64), \
            ((128, 7, 7, 512), (3, 3), (1, 1), (1, 1), 512):
        xs, k, s, p, o = conv
        form = cdw.formulation(xs[3])
        half = cdw.launch_plan(form, k, s, p, xs, o, torch.float16)
        assert half.kernel == "tensor-core"
        assert half == cdw.launch_plan(form, k, s, p, xs, o, torch.bfloat16)


# ------------------------------------------ float32: 3xTF32 (tf32x3 route)

# LeNet's two convolutions and the ConvLSTM cell's two, as the symbolic
# paths hand them to K1b: (NHWC x, kernel, stride, pad, O)
LENET = [((64, 28, 28, 1), (5, 5), (1, 1), (0, 0), 20),
         ((64, 12, 12, 20), (5, 5), (1, 1), (0, 0), 50)]
CONVLSTM = [((8, 16, 16, c), (3, 3), (1, 1), (1, 1), 64) for c in (3, 16)]


def _ssd300_convs(batch=32, size=300):
    """(NHWC x, kernel, stride, pad, O, dilate) of every convolution of
    SSD300 at (batch, 3, size, size), in forward order."""
    from mxnet_tpu_torch.gluon.model_zoo.ssd import SSD300

    net = SSD300(20, device="meta")
    convs = []

    def hook(mod, args, out):
        n, c, h, w = args[0].shape
        kw = mod._kwargs
        convs.append(((n, h, w, c), kw["kernel"], kw["stride"], kw["pad"],
                      kw["num_filter"], kw["dilate"]))

    for m in net.modules():
        if isinstance(m, tgnn.Conv2D):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.empty(batch, 3, size, size, device="meta"))
    return convs


def _f32_shapes():
    """Every float32 convolution shape of the main paths: ResNet-50's
    (the card's float32 gradient check), SSD300's, LeNet's, ConvLSTM's."""
    return ([c + ((1, 1),) for c in _resnet50_convs()] + _ssd300_convs()
            + [c + ((1, 1),) for c in LENET + CONVLSTM])


def _dilated_positions(xs, k, s, p, d):
    n, h, w, _ = xs
    return n * ((h + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1) \
        * ((w + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1)


def test_float32_plan_is_tf32x3_at_every_main_path_shape():
    """At every float32 shape of the main paths (ResNet-50's 53, SSD300's
    35, LeNet's 2, ConvLSTM's 2) the plan is the tensor-core kernel's
    tf32x3 route: chunks of whole 32-position stages that cover the
    reduction once, a tile of 128 output channels above O = 64 and O
    padded to 16, 24, 32 or 64 at or below it, 16-byte loads where the
    channel count is a multiple of 4."""
    shapes = _f32_shapes()
    assert len(shapes) == 53 + 35 + 2 + 2
    narrow = 0
    for xs, k, s, p, o, d in shapes:
        form = cdw.formulation(xs[3])
        plan = cdw.launch_plan(form, k, s, p, xs, o, torch.float32, d)
        positions = _dilated_positions(xs, k, s, p, d)
        assert (plan.kernel, plan.route) == ("tensor-core", "tf32x3")
        assert plan.chunk % cdw.TF32_STAGE == 0
        assert plan.chunk >= 4 * cdw.TF32_STAGE or plan.splits == 1
        assert (plan.splits - 1) * plan.chunk < positions \
            <= plan.splits * plan.chunk, (xs, k, o)
        want = min((t for t in cdw.TF32_NARROW_O if o <= t), default=128)
        assert plan.tile_o == want, (xs, o)
        narrow += plan.tile_o < 128
        assert plan.x_loads == ("16-byte" if xs[3] % 4 == 0 else "4-byte")
        assert plan.dy_loads == ("16-byte" if o % 4 == 0 else "4-byte")
        assert plan.ws_elems == (0 if plan.splits == 1 else
                                 plan.splits * o * k[0] * k[1] * xs[3])
    # ResNet-50's stem and the 6 of stage 1 with 64 channels, SSD300's
    # conv1_x and its 3 + 3 loc heads, LeNet's and ConvLSTM's 4
    assert narrow == 7 + 2 + 6 + 4


# (NHWC x, kernel, stride, pad, O, dilate): (splits, chunk) of the plan
PINNED_F32_SPLITS = {
    ((32, 300, 300, 3), (3, 3), (1, 1), (1, 1), 64, (1, 1)): (132, 21824),
    ((32, 300, 300, 64), (3, 3), (1, 1), (1, 1), 64, (1, 1)): (79, 36480),
    ((32, 38, 38, 512), (3, 3), (1, 1), (1, 1), 512, (1, 1)): (8, 5792),
    ((32, 38, 38, 512), (3, 3), (1, 1), (1, 1), 16, (1, 1)): (11, 4224),
    ((32, 19, 19, 512), (3, 3), (1, 1), (6, 6), 1024, (6, 6)): (4, 2912),
    ((32, 19, 19, 1024), (3, 3), (1, 1), (1, 1), 126, (1, 1)): (7, 1664),
    ((32, 1, 1, 256), (3, 3), (1, 1), (1, 1), 16, (1, 1)): (1, 32),
    ((64, 28, 28, 1), (5, 5), (1, 1), (0, 0), 20, (1, 1)): (128, 288),
    ((8, 16, 16, 16), (3, 3), (1, 1), (1, 1), 64, (1, 1)): (16, 128),
    ((128, 224, 224, 3), (7, 7), (2, 2), (3, 3), 64, (1, 1)): (66, 24352),
}


@pytest.mark.parametrize("conv", sorted(PINNED_F32_SPLITS))
def test_float32_split_counts_are_pinned(conv):
    """The float32 split-K plan at SSD300's large maps, a dilated layer, a
    loc head, a 1 x 1 map, LeNet's conv1, the ConvLSTM cell's h2h and
    ResNet-50's stem: pinned, so that a change to the cost model shows."""
    xs, k, s, p, o, d = conv
    plan = cdw.launch_plan(cdw.formulation(xs[3]), k, s, p, xs, o,
                           torch.float32, d)
    assert (plan.splits, plan.chunk) == PINNED_F32_SPLITS[conv]


@pytest.mark.parametrize("o,tile", [(1, 16), (16, 16), (17, 24), (24, 24),
                                    (25, 32), (32, 32), (33, 64), (50, 64),
                                    (64, 64), (65, 128), (126, 128),
                                    (512, 128)])
def test_float32_narrow_o_tiling(o, tile):
    """O <= 64 puts dY on wgmma's N at O padded to 16, 24, 32 or 64; the
    C variant carries the width / 8 in bits 2-6 (bf16 keeps its 64 or
    128 tile and bit 2)."""
    xs = (8, 10, 10, 64)
    plan = cdw.launch_plan("im2col", (3, 3), (1, 1), (1, 1), xs, o,
                           torch.float32)
    assert plan.tile_o == tile
    assert plan.variant >> 2 == tile // 8
    assert plan.variant & 3 == (o % 4 == 0) | 2
    half = cdw.launch_plan("im2col", (3, 3), (1, 1), (1, 1), xs, o,
                           torch.bfloat16)
    assert half.route == "wgmma" and half.tile_o == (64 if o <= 64 else 128)
    assert half.variant >> 2 == (o <= 64)


def _tf32_parts(a):
    """float32 ``a`` split as the kernel splits it: hi rounded to tf32 on
    its bits ((bits + 0x1000) & ~0x1fff), lo = a - hi as the tensor core
    reads it (its low 13 bits dropped)."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    hi = (bits + 0x1000) & 0xffffe000
    hi = torch.where(hi >= 2 ** 31, hi - 2 ** 32, hi).to(torch.int32)
    hi = hi.view(torch.float32)
    lo = (a - hi).contiguous().view(torch.int32) & ~0x1fff
    return hi, lo.view(torch.float32)


def _x_rows(x, k, s, p, d):
    """X^ [P, KH*KW*I]: x at every position's taps, (r, s, i) order."""
    n, h, w, _ = x.shape
    oh = (h + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    xp = torch.nn.functional.pad(x, (0, 0, p[1], p[1], p[0], p[0]))
    taps = [xp[:, r * d[0]:r * d[0] + s[0] * (oh - 1) + 1:s[0],
               c * d[1]:c * d[1] + s[1] * (ow - 1) + 1:s[1]]
            for r in range(k[0]) for c in range(k[1])]
    return torch.cat(taps, -1).reshape(n * oh * ow, -1)


def _tf32x3_emulation(x, dy, k, s, p, d, plan):
    """The kernel's arithmetic: each split's chunk summed stage by stage
    (32 positions), a stage's three tf32 products lo*hi + hi*lo + hi*hi
    in float32 added to the running float32 sum, the splits' partials
    added in split order."""
    xr = _x_rows(x, k, s, p, d)
    yr = dy.reshape(-1, dy.shape[-1])
    xh, xl = _tf32_parts(xr)
    yh, yl = _tf32_parts(yr)
    positions = xr.shape[0]
    total = None
    for sp in range(plan.splits):
        acc = torch.zeros(yr.shape[1], xr.shape[1])
        end = min((sp + 1) * plan.chunk, positions)
        for st in range(sp * plan.chunk, end, cdw.TF32_STAGE):
            at = slice(st, min(st + cdw.TF32_STAGE, end))
            acc = acc + (yl[at].T @ xh[at] + yh[at].T @ xl[at]
                         + yh[at].T @ xh[at])
        total = acc if total is None else total + acc
    return total.reshape(yr.shape[1], k[0], k[1], x.shape[3])


def _dw_float64(x, dy, k, s, p, d):
    n = _x_rows(x.double(), k, s, p, d)
    return (dy.double().reshape(-1, dy.shape[-1]).T @ n).reshape(
        dy.shape[-1], k[0], k[1], x.shape[3])


@pytest.mark.parametrize("xs,k,s,p,o,d", [
    ((2, 13, 13, 5), (3, 3), (1, 1), (2, 2), 24, (2, 2)),     # dilated
    ((2, 30, 30, 3), (7, 7), (2, 2), (3, 3), 64, (1, 1)),     # I = 3
    ((2, 12, 12, 128), (3, 3), (1, 1), (1, 1), 16, (1, 1)),   # O = 16
    ((6, 14, 13, 20), (3, 3), (1, 1), (1, 1), 100, (1, 1)),   # ragged end
], ids=["dilated", "stem-I3", "loc-head-O16", "partial-last-chunk"])
def test_tf32x3_emulation_is_float32_accurate(xs, k, s, p, o, d):
    """A plain emulation of the tf32x3 route's arithmetic (the split by
    the kernel's bit formula, three tf32 products a stage into float32,
    the plan's stage and split order) against the plain version, within
    1e-5 of its largest magnitude, and against a float64 dW, within 4x
    the float32 plain version's own error."""
    rs = np.random.RandomState(11)
    n, h, w, ci = xs
    oh = (h + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    x = torch.from_numpy(rs.randn(*xs).astype(np.float32))
    dy = torch.from_numpy(rs.randn(n, oh, ow, o).astype(np.float32))
    plan = cdw.launch_plan(cdw.formulation(ci), k, s, p, xs, o,
                           torch.float32, d)
    if xs[0] == 6:
        # several splits, the last chunk and its last stage short
        positions = n * oh * ow
        assert plan.splits > 1 and positions % plan.chunk % 32 != 0
    got = _tf32x3_emulation(x, dy, k, s, p, d, plan)
    ref = cdw.conv_dw_reference(x, dy, k, s, p, d)
    want = _dw_float64(x, dy, k, s, p, d)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    e_emulated = float((got.double() - want).abs().max())
    e_plain = float((ref.double() - want).abs().max())
    assert e_emulated <= 4 * e_plain, (e_emulated, e_plain)
    # the split itself: hi + lo gives x back within the tf32 reading of lo
    hi, lo = _tf32_parts(x)
    assert torch.equal(hi.view(torch.int32) & 0x1fff,
                       torch.zeros_like(hi, dtype=torch.int32))
    assert float(((hi + lo) - x).abs().max()) <= 2.0 ** -21 * float(
        x.abs().max())
