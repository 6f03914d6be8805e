"""Grouped, 1-D and 3-D convolutions, transposed convolutions, 1-D and
3-D pooling and their Gluon layers in the port, against the JAX package
on the CPU.

On the CPU the kernel wrappers run their plain versions: K1's grouped dW
(``conv_dw_reference`` over each group's channel slice) and the
transposed convolution's dW (the same function with the roles of x and
dy swapped).

Tolerances:
- the plain dW, grouped or swapped, against the weight cotangent of
  ``jax.vjp``: 2e-4 of the largest magnitude, as
  ``tests/test_torch_conv.py`` holds dW (sums of a few hundred float32
  products in another order);
- an op's output and its data, weight and bias gradients against
  ``jax.vjp`` of the JAX op under the same cotangent, float32: 1e-5
  (rtol, and atol scaled by the largest magnitude when it exceeds 1);
  pooling's max picks the same element on continuous data (no ties);
- a Gluon layer's output and gradients of ``sum(out^2)``: 1e-5, as
  ``tests/test_torch_gluon_nchw.py`` holds the 2-D layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import mxnet_tpu as mx
import mxnet_tpu.ops.nn as jops
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgl
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import conv_dw as cdw
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops import registry as treg

DW_TOL = 2e-4
TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _rand(rng, shape):
    return rng.randn(*shape).astype(np.float32)


# ------------------------------------------------ K1's grouped plain dW

# (x NHWC, kernel, stride, pad, dilate, O, groups): I/G = 3, 12 and 1
GROUPED = [
    ((2, 9, 9, 6), (3, 3), (1, 1), (1, 1), (1, 1), 4, 2),
    ((2, 8, 7, 24), (3, 3), (2, 2), (1, 1), (1, 1), 8, 2),
    ((2, 10, 10, 8), (3, 3), (2, 2), (1, 1), (1, 1), 8, 8),
    ((2, 11, 11, 8), (3, 3), (1, 1), (2, 2), (2, 2), 16, 8),
    ((2, 12, 12, 64), (3, 3), (1, 1), (1, 1), (1, 1), 64, 32),
]


def _jax_conv_dw(x, dy, k, s, p, d, groups, w_in):
    dn = lax.conv_dimension_numbers(x.shape, (dy.shape[3],) + k + (w_in,),
                                    ("NHWC", "OHWI", "NHWC"))

    def conv(w):
        return lax.conv_general_dilated(
            jnp.asarray(x), w, s, [(pp, pp) for pp in p], rhs_dilation=d,
            dimension_numbers=dn, feature_group_count=groups)

    w0 = jnp.zeros((dy.shape[3],) + k + (w_in,), jnp.float32)
    _, vjp = jax.vjp(conv, w0)
    return np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("case", GROUPED, ids=lambda c: "I%d-G%d-O%d" % (
    c[0][3], c[6], c[5]))
def test_grouped_plain_dw_matches_jax_vjp(case):
    xs, k, s, p, d, o, g = case
    rng = np.random.RandomState(1)
    x = _rand(rng, xs)
    oh = (xs[1] + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    ow = (xs[2] + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    dy = _rand(rng, (xs[0], oh, ow, o))
    got = cdw.conv_dw(torch.from_numpy(x), torch.from_numpy(dy), k, s, p, d,
                      g).numpy()
    want = _jax_conv_dw(x, dy, k, s, p, d, g, xs[3] // g)
    assert got.shape == want.shape == (o,) + k + (xs[3] // g,)
    _close(got, want, DW_TOL)


def test_grouped_launch_plans_follow_a_groups_widths():
    """The loads, the tile and the formulation follow I/G and O/G: a
    group's slice keeps 16-byte loads only where its width is whole 16
    bytes (bf16: 8 channels; float32: 4); the split plan counts every
    group's tiles; the workspace holds every group's dW."""
    bf16, f32 = torch.bfloat16, torch.float32
    plan = cdw.launch_plan("im2col", (3, 3), (1, 1), (1, 1),
                           (128, 56, 56, 128), 128, bf16, (1, 1), 32)
    assert (plan.x_loads, plan.dy_loads, plan.tile_o) == (
        "register-staged", "register-staged", 64)
    plan = cdw.launch_plan("im2col", (3, 3), (1, 1), (1, 1),
                           (2, 8, 8, 24), 16, f32, (1, 1), 2)
    assert (plan.x_loads, plan.dy_loads, plan.tile_o) == (
        "16-byte", "16-byte", 16)
    plan = cdw.launch_plan("im2col", (3, 3), (1, 1), (1, 1),
                           (128, 112, 112, 32), 32, bf16, (1, 1), 32)
    assert (plan.x_loads, plan.dy_loads) == ("register-staged",) * 2
    assert plan.ws_elems == plan.splits * 32 * 9 * 1
    plan = cdw.launch_plan("im2col", (3, 3), (1, 1), (1, 1),
                           (2, 8, 8, 48), 48, bf16, (1, 1), 3)
    assert (plan.x_loads, plan.dy_loads) == ("16-byte", "16-byte")
    # I/G, not I, picks the formulation
    assert cdw.formulation(256 // 32) == "im2col"
    assert cdw.formulation(256) == "pertap"
    one = cdw.split_plan("im2col", (3, 3), 1, 1, 128 * 112 * 112,
                         bf16, 1)
    many = cdw.split_plan("im2col", (3, 3), 1, 1, 128 * 112 * 112,
                          bf16, 32)
    assert many[0] < one[0]  # 32 groups fill the card with fewer splits
    with pytest.raises(MXNetError, match="groups"):
        cdw.conv_dw(torch.zeros(1, 4, 4, 6), torch.zeros(1, 2, 2, 4),
                    (3, 3), groups=4)


# ------------------------------------------- the swapped-role plain dW

DECONV = [
    # (x NCHW, weight (I, O/G, KH, KW), stride, pad, dilate, adj, groups)
    ((2, 4, 5, 5), (4, 3, 4, 4), (2, 2), (1, 1), (1, 1), (0, 0), 1),
    ((2, 6, 5, 4), (6, 2, 3, 3), (2, 2), (1, 1), (1, 1), (1, 1), 2),
    ((2, 4, 4, 4), (4, 1, 3, 3), (1, 1), (2, 2), (2, 2), (0, 0), 4),
]


@pytest.mark.parametrize("case", DECONV, ids=lambda c: "G%d-adj%d" % (
    c[6], c[5][0]))
def test_swapped_role_plain_dw_matches_jax_vjp(case):
    """A transposed convolution's dW is the convolution dW of its
    output's gradient over its input (dy as x, x as dy) at the same
    stride, pad, dilation and groups, seen as (I, O/G, KH, KW)."""
    xs, ws, s, p, d, a, g = case
    rng = np.random.RandomState(2)
    x, w = _rand(rng, xs), _rand(rng, ws)

    def deconv(ww):
        return jops.deconvolution(jnp.asarray(x), ww, kernel=ws[2:],
                                  stride=s, pad=p, dilate=d, adj=a,
                                  num_group=g)

    out, vjp = jax.vjp(deconv, jnp.asarray(w))
    dy = _rand(rng, out.shape)
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    x_nhwc = torch.from_numpy(x).permute(0, 2, 3, 1).contiguous()
    dy_nhwc = torch.from_numpy(dy).permute(0, 2, 3, 1).contiguous()
    got = cdw.conv_dw_reference(dy_nhwc, x_nhwc, ws[2:], s, p, d, g)
    _close(got.permute(0, 3, 1, 2).numpy(), want, DW_TOL)


# ------------------------------------------------- the ops, forward and vjp

def _op_vjp(name, arrays, attrs, grad_of, seed=3):
    """The JAX op's output and the cotangent's vjp on ``grad_of`` inputs,
    and the port's under the same cotangent."""
    jop = jax.tree_util.Partial(
        lambda *a: jops.__dict__[name](*a, **attrs))
    jargs = [jnp.asarray(a) for a in arrays]

    def f(*diff):
        args = list(jargs)
        for i, v in zip(grad_of, diff):
            args[i] = v
        return jop(*args)

    out, vjp = jax.vjp(f, *[jargs[i] for i in grad_of])
    cot = _rand(np.random.RandomState(seed), out.shape)
    want_grads = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    tens = [torch.from_numpy(a.copy()) for a in arrays]
    for i in grad_of:
        tens[i].requires_grad_()
    port_name = {"convolution": "Convolution",
                 "deconvolution": "Deconvolution",
                 "pooling": "Pooling"}[name]
    with torch.enable_grad():
        got = treg.apply_op(port_name, *tens, **attrs)
        got.backward(torch.from_numpy(cot))
    return (got.detach().numpy(), np.asarray(out),
            [tens[i].grad.numpy() for i in grad_of], want_grads)


CONVS = {
    "nchw-groups2-I3": ([(2, 6, 7, 7), (4, 3, 3, 3), (4,)],
                        dict(kernel=(3, 3), pad=(1, 1), num_filter=4,
                             num_group=2)),
    "nhwc-groups2-I12": ([(2, 7, 6, 24), (8, 3, 3, 12), (8,)],
                         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              num_filter=8, num_group=2, layout="NHWC")),
    "nhwc-depthwise-I1": ([(2, 9, 9, 8), (8, 3, 3, 1)],
                          dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               num_filter=8, num_group=8, no_bias=True,
                               layout="NHWC")),
    "nchw-depthwise-dilated": ([(2, 4, 11, 11), (8, 1, 3, 3)],
                               dict(kernel=(3, 3), pad=(2, 2),
                                    dilate=(2, 2), num_filter=8,
                                    num_group=4, no_bias=True)),
    "ncw": ([(2, 3, 13), (5, 3, 3), (5,)],
            dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=5)),
    "nwc-groups": ([(2, 13, 6), (4, 4, 3)],
                   dict(kernel=(4,), dilate=(2,), num_filter=4, num_group=2,
                        no_bias=True, layout="NWC")),
    "ncdhw": ([(2, 3, 5, 6, 6), (4, 3, 3, 3, 3), (4,)],
              dict(kernel=(3, 3, 3), stride=(1, 2, 2), pad=(1, 1, 1),
                   num_filter=4)),
    "ndhwc-groups": ([(2, 4, 5, 5, 4), (4, 2, 3, 3, 2)],
                     dict(kernel=(2, 3, 3), pad=(0, 1, 1), num_filter=4,
                          num_group=2, no_bias=True, layout="NDHWC")),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_convolution_and_gradients_match_jax(case):
    shapes, attrs = CONVS[case]
    rng = np.random.RandomState(4)
    arrays = [_rand(rng, s) for s in shapes]
    got, want, grads, want_grads = _op_vjp(
        "convolution", arrays, attrs, list(range(len(arrays))))
    assert got.shape == want.shape
    _close(got, want)
    for g, w, what in zip(grads, want_grads, ("data", "weight", "bias")):
        _close(g, w, TOL, what)


DECONVS = {
    "2d-adj-groups-bias-under-no-bias": (
        [(2, 4, 5, 5), (4, 3, 4, 4), (6,)],
        dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), adj=(1, 1),
             num_filter=6, num_group=2, no_bias=True)),
    "2d-dilated": ([(2, 3, 6, 5), (3, 2, 3, 3)],
                   dict(kernel=(3, 3), stride=(1, 1), pad=(2, 2),
                        dilate=(2, 2), num_filter=2)),
    "2d-target-shape": ([(1, 2, 4, 4), (2, 3, 3, 3)],
                        dict(kernel=(3, 3), stride=(2, 2), num_filter=3,
                             target_shape=(9, 9))),
    "1d": ([(2, 3, 7), (3, 2, 3), (2,)],
           dict(kernel=(3,), stride=(2,), pad=(1,), adj=(1,),
                num_filter=2)),
    "3d-groups": ([(2, 4, 3, 3, 3), (4, 1, 3, 3, 3)],
                  dict(kernel=(3, 3, 3), stride=(2, 2, 2), pad=(1, 1, 1),
                       num_filter=2, num_group=2)),
}


@pytest.mark.parametrize("case", sorted(DECONVS))
def test_deconvolution_and_gradients_match_jax(case):
    shapes, attrs = DECONVS[case]
    rng = np.random.RandomState(5)
    arrays = [_rand(rng, s) for s in shapes]
    got, want, grads, want_grads = _op_vjp(
        "deconvolution", arrays, attrs, list(range(len(arrays))))
    assert got.shape == want.shape
    _close(got, want)
    for g, w, what in zip(grads, want_grads, ("data", "weight", "bias")):
        _close(g, w, TOL, what)


POOLS = [(pt, conv, layout)
         for pt in ("max", "avg", "sum", "lp")
         for conv in ("valid", "full")
         for layout in ("NCW", "NWC", "NCDHW", "NDHWC")]


@pytest.mark.parametrize("pool_type,convention,layout", POOLS)
def test_nd_pooling_and_gradient_match_jax(pool_type, convention, layout):
    nd = len(layout) - 2
    shape = {1: (2, 3, 10), 2: None, 3: (2, 3, 5, 7, 6)}[nd]
    if layout.endswith("C"):
        shape = (shape[0],) + shape[2:] + (shape[1],)
    attrs = dict(kernel=(3,) * nd, stride=(2,) * nd, pad=(1,) * nd,
                 pool_type=pool_type, pooling_convention=convention,
                 layout=layout, p_value=3, count_include_pad=
                 convention == "valid")
    x = np.random.RandomState(6).rand(*shape).astype(np.float32) + 0.1
    got, want, (g,), (w,) = _op_vjp("pooling", [x], attrs, [0])
    assert got.shape == want.shape
    _close(got, want)
    _close(g, w, TOL, "data")


@pytest.mark.parametrize("layout", ["NCW", "NCDHW"])
@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_global_nd_pooling_matches_jax(layout, pool_type):
    shape = (2, 3, 9) if layout == "NCW" else (2, 3, 4, 5, 3)
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    got, want, (g,), (w,) = _op_vjp(
        "pooling", [x], dict(kernel=(1,) * (len(shape) - 2),
                             pool_type=pool_type, global_pool=True,
                             layout=layout), [0])
    _close(got, want)
    _close(g, w, TOL, "data")


# ---------------------------------------------------- the Gluon layers

def _params(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _run_both(make, x, seed=1):
    """``make(nn, kw)`` in both packages, the port's with its input width
    deferred; the JAX layer initialised and run first, its weights carried
    into the port's after the port's first forward gave its weight a
    shape; one recorded forward and backward of ``sum(out^2)`` in each."""
    mx.random.seed(seed)
    jl = make(jgl.nn, {})
    jl.initialize(mx.init.Xavier())
    jl(mx.nd.array(x))
    tl = make(tnn, {"device": "cpu"})
    tl.initialize()
    tl(torch.from_numpy(x))
    load_mxnet_tpu_params(tl, _params(jl))
    xj = mx.nd.array(x)
    xj.attach_grad()
    with jag.record():
        jout = jl(xj)
        (jout * jout).sum().backward()
    xt = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        tout = tl(xt)
    autograd.backward((tout * tout).sum())
    jg = {k: p.grad().asnumpy()
          for k, p in jl._collect_params_with_prefix().items()
          if p.grad_req != "null"}
    jg["data"] = xj.grad.asnumpy()
    tg = {k: p.grad.numpy()
          for k, p in tl._collect_params_with_prefix().items()
          if p.requires_grad}
    tg["data"] = xt.grad.numpy()
    return tout.detach().numpy(), jout.asnumpy(), tg, jg


LAYERS = {
    "Conv1D": (lambda m, kw: m.Conv1D(4, 3, strides=2, padding=1, **kw),
               (2, 3, 11)),
    "Conv1D-groups-nwc": (lambda m, kw: m.Conv1D(
        6, 3, groups=3, layout="NWC", activation="relu", **kw), (2, 9, 6)),
    "Conv2D-groups": (lambda m, kw: m.Conv2D(8, 3, padding=1, groups=2,
                                             **kw), (2, 6, 7, 7)),
    "Conv2D-depthwise-nhwc": (lambda m, kw: m.Conv2D(
        8, 3, strides=2, padding=1, groups=8, use_bias=False,
        layout="NHWC", **kw), (2, 9, 9, 8)),
    "Conv3D": (lambda m, kw: m.Conv3D(4, 3, padding=1, **kw),
               (2, 3, 4, 5, 5)),
    "Conv3D-ndhwc": (lambda m, kw: m.Conv3D(4, (2, 3, 3), layout="NDHWC",
                                            **kw), (2, 4, 5, 5, 3)),
    "Conv1DTranspose": (lambda m, kw: m.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1, **kw), (2, 4, 6)),
    "Conv2DTranspose": (lambda m, kw: m.Conv2DTranspose(
        4, 4, strides=2, padding=1, **kw), (2, 3, 5, 5)),
    "Conv2DTranspose-groups": (lambda m, kw: m.Conv2DTranspose(
        6, 3, strides=2, output_padding=1, groups=2, **kw), (2, 4, 4, 4)),
    "Conv3DTranspose": (lambda m, kw: m.Conv3DTranspose(
        2, 3, strides=2, padding=1, **kw), (2, 3, 3, 3, 3)),
    "MaxPool1D": (lambda m, kw: m.MaxPool1D(3, 2, 1), (2, 3, 10)),
    "MaxPool3D": (lambda m, kw: m.MaxPool3D(2, ceil_mode=True),
                  (2, 3, 5, 4, 5)),
    "AvgPool1D": (lambda m, kw: m.AvgPool1D(3, 2, 1), (2, 3, 10)),
    "AvgPool2D": (lambda m, kw: m.AvgPool2D(3, 2, 1,
                                            count_include_pad=False),
                  (2, 3, 7, 8)),
    "AvgPool3D": (lambda m, kw: m.AvgPool3D(2, ceil_mode=True),
                  (2, 3, 5, 4, 5)),
    "GlobalMaxPool1D": (lambda m, kw: m.GlobalMaxPool1D(), (2, 3, 7)),
    "GlobalMaxPool2D": (lambda m, kw: m.GlobalMaxPool2D(), (2, 3, 5, 4)),
    "GlobalMaxPool3D": (lambda m, kw: m.GlobalMaxPool3D(), (2, 3, 3, 4, 2)),
    "GlobalAvgPool1D": (lambda m, kw: m.GlobalAvgPool1D(), (2, 3, 7)),
    "GlobalAvgPool3D": (lambda m, kw: m.GlobalAvgPool3D(), (2, 3, 3, 4, 2)),
    "ReflectionPad2D": (lambda m, kw: m.ReflectionPad2D(2), (2, 3, 5, 6)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_with_deferred_widths_matches_jax(case):
    make, shape = LAYERS[case]
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    tout, jout, tg, jg = _run_both(make, x)
    assert tout.shape == jout.shape
    _close(tout, jout, TOL, "output")
    assert set(tg) == set(jg)
    for k in jg:
        _close(tg[k], jg[k], TOL, k)


def test_layer_shapes_and_refusals():
    conv = tnn.Conv2DTranspose(6, 3, groups=2, in_channels=4, device="cpu")
    assert tuple(conv.weight.shape) == (4, 3, 3, 3)
    conv = tnn.Conv3D(4, 3, groups=2, in_channels=6, layout="NDHWC",
                      device="cpu")
    assert tuple(conv.weight.shape) == (4, 3, 3, 3, 3)
    with pytest.raises(MXNetError, match="channel-first"):
        tnn.Conv2DTranspose(4, 3, layout="NHWC", device="cpu")
    with pytest.raises(MXNetError, match="NCW"):
        tnn.Conv1D(4, 3, layout="NCHW", device="cpu")
    with pytest.raises(MXNetError, match="groups"):
        tnn.Conv1D(4, 3, groups=3, device="cpu")
    with pytest.raises(MXNetError, match="NCDHW"):
        tnn.MaxPool3D(layout="NCHW")
    with pytest.raises(MXNetError, match="H and W"):
        tnn.ReflectionPad2D((1, 1, 0, 0, 1, 1, 1, 1))
    with pytest.raises(MXNetError, match="channel-first"):
        tops.deconvolution(torch.zeros(1, 4, 4, 2), torch.zeros(2, 2, 3, 3),
                           layout="NHWC")
