"""The Gluon layers in their default NCHW layout, dilation, BatchNorm over
axis 1, Sequential, the losses, L2Normalization and VGG of the port
against the JAX package, on the CPU.

Tolerances:
- a layer's forward and gradients, float32: 1e-5 (rtol, and atol scaled
  by the largest magnitude when it exceeds 1): one float32 op or a
  convolution's sums, in another order in each package;
- the plain dilated dW against ``jax.vjp`` of ``lax.conv_general_dilated``:
  2e-4, as ``tests/test_torch_conv.py`` holds dW (sums of a few hundred
  float32 products in another order);
- the losses: 1e-6 relative (1e-5 where they sum over a row), element-wise
  float32 formulas of the same operations;
- VGG's output: 1e-4 of its largest magnitude (eight convolutions and
  three dense layers, each summing in its own order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgl
from mxnet_tpu.gluon.model_zoo.vision import vgg as jvgg
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import vgg as tvgg
from mxnet_tpu_torch.ops import conv_dw as cdw
from mxnet_tpu_torch.ops import nn as tops


def _close(got, want, tol, what=""):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _params(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _run_both(make, x, seed=1):
    """``make(nn, kw)`` built in both packages, the JAX one initialised and
    run first, its weights carried into the port's; one recorded forward
    and backward of ``sum(out^2)`` in each.  Returns (port layer, port
    output, JAX output, port grads, JAX grads)."""
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
    tg = {k: p.grad.numpy() for k, p in tl.collect_params().items()
          if p.requires_grad}
    tg["data"] = xt.grad.numpy()
    return tl, tout, jout.asnumpy(), tg, jg


def _check_grads(tg, jg, tol):
    assert set(tg) == set(jg)
    for k in jg:
        _close(tg[k], jg[k], tol, k)


LAYERS = {
    "conv-default": (lambda m, kw: m.Conv2D(6, 3, padding=1, **kw),
                     (2, 3, 9, 9)),
    "conv-stride-bias-relu": (lambda m, kw: m.Conv2D(
        5, (3, 2), strides=2, padding=(1, 0), activation="relu", **kw),
        (2, 4, 9, 8)),
    "conv-dilation-2": (lambda m, kw: m.Conv2D(4, 3, padding=2, dilation=2,
                                               **kw), (2, 3, 11, 11)),
    "conv-dilation-6": (lambda m, kw: m.Conv2D(4, 3, padding=6, dilation=6,
                                               **kw), (2, 5, 13, 13)),
    "conv-dilation-2-nhwc": (lambda m, kw: m.Conv2D(
        4, 3, padding=1, dilation=2, layout="NHWC", **kw), (2, 11, 11, 3)),
    "conv-dilation-6-nhwc": (lambda m, kw: m.Conv2D(
        4, 3, strides=2, padding=6, dilation=6, layout="NHWC", **kw),
        (2, 13, 13, 5)),
    "maxpool-default": (lambda m, kw: m.MaxPool2D(), (2, 3, 8, 8)),
    "maxpool-ceil": (lambda m, kw: m.MaxPool2D(2, 2, ceil_mode=True),
                     (2, 3, 7, 9)),
    "maxpool-3x3-s1-p1": (lambda m, kw: m.MaxPool2D(3, 1, 1), (2, 3, 5, 6)),
    "global-avg": (lambda m, kw: m.GlobalAvgPool2D(), (2, 3, 5, 4)),
    "batchnorm-axis-1": (lambda m, kw: m.BatchNorm(**kw), (2, 3, 5, 4)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_default_layout_layer_matches_jax(case):
    make, shape = LAYERS[case]
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    tl, tout, jout, tg, jg = _run_both(make, x)
    assert tout.shape == jout.shape
    _close(tout.detach().numpy(), jout, 1e-5, "output")
    _check_grads(tg, jg, 1e-5)


def test_batchnorm_axis_1_running_statistics_match_jax():
    x = np.random.RandomState(2).randn(4, 3, 5, 6).astype(np.float32)
    jl, tl = jgl.nn.BatchNorm(), tnn.BatchNorm(device="cpu")
    jl.initialize()
    jl(mx.nd.array(x))
    tl.initialize()
    tl(torch.from_numpy(x))
    load_mxnet_tpu_params(tl, _params(jl))
    for _ in range(2):
        with jag.record():
            jout = jl(mx.nd.array(x))
        with autograd.record():
            tout = tl(torch.from_numpy(x))
    _close(tout.detach().numpy(), jout.asnumpy(), 1e-5)
    for k, v in _params(jl).items():
        _close(tl.collect_params()[k].detach().numpy(), v, 1e-5, k)


def test_nchw_results_are_channels_last_views():
    """An NCHW layer's result lies channels-last in memory, so the next
    layer sees its NHWC view without a copy; the weights are OIHW."""
    conv = tnn.Conv2D(8, 3, padding=1, in_channels=3, device="cpu")
    assert tuple(conv.weight.shape) == (8, 3, 3, 3)
    conv.initialize()
    y = conv(torch.randn(2, 3, 6, 7))
    assert y.shape == (2, 8, 6, 7)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert tops._nhwc(y).is_contiguous()
    z = tnn.MaxPool2D()(tnn.BatchNorm(in_channels=8, device="cpu")(y))
    assert z.is_contiguous(memory_format=torch.channels_last)
    # the head's (B, H, W, C) permute is contiguous: the reshape is a view
    assert z.permute(0, 2, 3, 1).is_contiguous()


def test_layouts_the_layers_refuse():
    with pytest.raises(MXNetError, match="NCHW"):
        tnn.Conv2D(4, 3, layout="NWC", device="cpu")
    with pytest.raises(MXNetError, match="NCHW"):
        tnn.MaxPool2D(layout="CHWN")
    with pytest.raises(MXNetError, match="groups"):
        tnn.Conv2D(4, 3, groups=3, device="cpu")


@pytest.mark.parametrize("xs,k,s,p,d,o", [
    ((2, 11, 11, 3), (3, 3), (1, 1), (2, 2), (2, 2), 4),
    ((2, 19, 19, 8), (3, 3), (1, 1), (6, 6), (6, 6), 16),
    ((2, 13, 12, 5), (3, 2), (2, 1), (1, 0), (2, 3), 6),
])
def test_dilated_plain_dw_matches_jax_vjp(xs, k, s, p, d, o):
    """conv_dw_reference with dilation against the weight cotangent of
    jax.vjp of lax.conv_general_dilated (NHWC, OHWI)."""
    rs = np.random.RandomState(4)
    x = rs.randn(*xs).astype(np.float32)
    w = rs.randn(o, *k, xs[3]).astype(np.float32)

    def conv(wt):
        return lax.conv_general_dilated(
            jnp.asarray(x), wt, s, [(p[0], p[0]), (p[1], p[1])],
            rhs_dilation=d, dimension_numbers=("NHWC", "OHWI", "NHWC"))

    out, vjp = jax.vjp(conv, jnp.asarray(w))
    dy = rs.randn(*out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(dy))
    got = cdw.conv_dw_reference(torch.from_numpy(x), torch.from_numpy(dy), k,
                                s, p, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    for form in ("pertap", "im2col"):
        run = cdw.conv_dw_pertap if form == "pertap" else cdw.conv_dw_im2col
        np.testing.assert_array_equal(
            run(torch.from_numpy(x), torch.from_numpy(dy), k, s, p,
                d).numpy(), got.numpy())
        plan = cdw.launch_plan(form, k, s, p, xs, o, torch.float32, d)
        assert plan.splits * plan.chunk >= dy.shape[0] * dy.shape[1] \
            * dy.shape[2] > (plan.splits - 1) * plan.chunk


def test_dilated_dw_checks_the_dilated_output_size():
    x = torch.zeros(1, 13, 13, 4)
    with pytest.raises(MXNetError, match="dilate"):
        cdw.conv_dw(x, torch.zeros(1, 13, 13, 8), (3, 3), (1, 1), (1, 1),
                    (6, 6))
    cdw.conv_dw(x, torch.zeros(1, 13, 13, 8), (3, 3), (1, 1), (6, 6), (6, 6))


def test_sequential_matches_jax():
    x = np.random.RandomState(8).randn(2, 3, 8, 8).astype(np.float32)

    def make(m, kw):
        net = m.Sequential(**kw)
        net.add(m.Conv2D(4, 3, padding=1, **kw), m.BatchNorm(**kw),
                m.Activation("relu"), m.MaxPool2D(2))
        net.add(m.Conv2D(5, 3, **kw))
        return net

    tl, tout, jout, tg, jg = _run_both(make, x)
    _close(tout.detach().numpy(), jout, 1e-5)
    _check_grads(tg, jg, 1e-5)
    assert len(tl) == 5 and isinstance(tl[0], tnn.Conv2D)
    assert isinstance(tl[1:3], tnn.Sequential) and len(tl[1:3]) == 2
    assert [type(b).__name__ for b in tl] == [
        "Conv2D", "BatchNorm", "Activation", "MaxPool2D", "Conv2D"]
    assert list(tl.collect_params())[:2] == ["0.weight", "0.bias"]


def _loss_inputs(seed, shape=(3, 4)):
    rs = np.random.RandomState(seed)
    pred = rs.randn(*shape).astype(np.float32)
    return rs, pred


LOSSES = {
    "L2Loss": ({}, lambda rs, p: [rs.randn(*p.shape)]),
    "L2Loss-weight": ({"weight": 3.0}, lambda rs, p: [rs.randn(*p.shape)]),
    "L1Loss": ({}, lambda rs, p: [rs.randn(*p.shape)]),
    "L1Loss-sample-weight": ({}, lambda rs, p: [rs.randn(*p.shape),
                                                rs.rand(p.shape[0], 1)]),
    "SigmoidBinaryCrossEntropyLoss": (
        {}, lambda rs, p: [rs.randint(0, 2, p.shape)]),
    "SigmoidBinaryCrossEntropyLoss-from-sigmoid": (
        {"from_sigmoid": True},
        lambda rs, p: [rs.randint(0, 2, p.shape)]),
    "KLDivLoss": ({}, lambda rs, p: [rs.dirichlet(np.ones(p.shape[1]),
                                                  p.shape[0])]),
    "KLDivLoss-logits": ({"from_logits": False},
                         lambda rs, p: [rs.dirichlet(np.ones(p.shape[1]),
                                                     p.shape[0])]),
    "HuberLoss": ({"rho": 0.7}, lambda rs, p: [rs.randn(*p.shape)]),
    "HingeLoss": ({}, lambda rs, p: [rs.choice([-1, 1], p.shape)]),
    "SquaredHingeLoss": ({"margin": 2},
                         lambda rs, p: [rs.choice([-1, 1], p.shape)]),
    "LogisticLoss": ({}, lambda rs, p: [rs.choice([-1, 1], p.shape)]),
    "LogisticLoss-binary": ({"label_format": "binary"},
                            lambda rs, p: [rs.randint(0, 2, p.shape)]),
    "TripletLoss": ({"margin": 0.5}, lambda rs, p: [rs.randn(*p.shape),
                                                    rs.randn(*p.shape)]),
    "CosineEmbeddingLoss": ({"margin": 0.1},
                            lambda rs, p: [rs.randn(*p.shape),
                                           rs.choice([-1, 1], p.shape[0])]),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case):
    kwargs, extra = LOSSES[case]
    name = case.split("-")[0]
    rs, pred = _loss_inputs(sum(map(ord, case)))
    if "from-sigmoid" in case:
        pred = 1.0 / (1.0 + np.exp(-pred))
    others = [np.asarray(a, dtype=np.float32) for a in extra(rs, pred)]
    want = getattr(jgl.loss, name)(**kwargs)(
        *[mx.nd.array(a) for a in [pred] + others]).asnumpy()
    tloss = getattr(gluon.loss, name)(**kwargs)
    pt = torch.from_numpy(pred).requires_grad_()
    with autograd.record():
        got = tloss(pt, *[torch.from_numpy(a) for a in others])
    assert got.shape == want.shape
    tol = 1e-5 if name in ("TripletLoss", "CosineEmbeddingLoss",
                           "KLDivLoss") else 1e-6
    _close(got.detach().numpy(), want, tol)
    autograd.backward(got.sum())
    assert torch.isfinite(pt.grad).all()


def test_sigmoid_bce_pos_weight_and_aliases():
    rs, pred = _loss_inputs(3)
    label = rs.randint(0, 2, pred.shape).astype(np.float32)
    pw = rs.rand(1, pred.shape[1]).astype(np.float32) + 0.5
    for from_sigmoid in (False, True):
        p = 1.0 / (1.0 + np.exp(-pred)) if from_sigmoid else pred
        want = jgl.loss.SigmoidBCELoss(from_sigmoid=from_sigmoid)(
            mx.nd.array(p), mx.nd.array(label), None,
            mx.nd.array(pw)).asnumpy()
        got = gluon.loss.SigmoidBCELoss(from_sigmoid=from_sigmoid)(
            torch.from_numpy(p), torch.from_numpy(label),
            pos_weight=torch.from_numpy(pw))
        _close(got.numpy(), want, 1e-6)
    assert gluon.loss.SigmoidBCELoss \
        is gluon.loss.SigmoidBinaryCrossEntropyLoss
    with pytest.raises(ValueError, match="signed or binary"):
        gluon.loss.LogisticLoss(label_format="0/1")


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization_matches_jax(mode):
    from mxnet_tpu.ops import nn as jops

    x = np.random.RandomState(6).randn(2, 5, 3, 4).astype(np.float32)
    want = np.asarray(jops.l2_normalization(jnp.asarray(x), mode=mode))
    xt = torch.from_numpy(x).requires_grad_()
    got = tops.l2_normalization(xt, mode=mode)
    _close(got.detach().numpy(), want, 1e-6)
    (jgrad,) = jax.grad(lambda a: jnp.sum(jops.l2_normalization(
        a, mode=mode) ** 3), argnums=(0,))(jnp.asarray(x))
    (got ** 3).sum().backward()
    _close(xt.grad.numpy(), np.asarray(jgrad), 1e-5)
    with pytest.raises(MXNetError, match="mode"):
        tops.l2_normalization(xt, mode="pixel")


@pytest.mark.parametrize("name", ["vgg11", "vgg11_bn"])
def test_vgg_matches_jax(name):
    """vgg11 and vgg11_bn at 32 x 32 (the 1 x 1 map after five pools), in
    predict mode (dropout off, BatchNorm by its running statistics), with
    the JAX weights carried by name."""
    x = np.random.RandomState(9).randn(2, 3, 32, 32).astype(np.float32)
    mx.random.seed(3)
    jnet = getattr(jvgg, name)(classes=7)
    jnet.initialize(mx.init.Xavier())
    want = jnet(mx.nd.array(x)).asnumpy()
    tnet = getattr(tvgg, name)(classes=7, device="cpu")
    tnet.initialize()
    tnet(torch.from_numpy(x))
    params = _params(jnet)
    assert list(tnet.state_dict(keep_vars=True)) == list(params)
    load_mxnet_tpu_params(tnet, params)
    got = tnet(torch.from_numpy(x))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)


def test_vgg_entry_points():
    net = tvgg.vgg16(classes=3, device="cpu")
    convs = [m for m in net.features if isinstance(m, tnn.Conv2D)]
    assert [c._kwargs["num_filter"] for c in convs] == [
        64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    assert len([m for m in tvgg.vgg19_bn(device="cpu").features
                if isinstance(m, tnn.BatchNorm)]) == 16
    for f in (tvgg.vgg13, tvgg.vgg19, tvgg.vgg13_bn, tvgg.vgg16_bn):
        assert isinstance(f(device="cpu"), tvgg.VGG)
    with pytest.raises(RuntimeError, match="pretrained"):
        tvgg.vgg11(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="no VGG of 12"):
        tvgg.get_vgg(12, device="cpu")
