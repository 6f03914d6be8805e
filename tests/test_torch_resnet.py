"""The port's ResNet v1 (mxnet_tpu_torch/gluon/model_zoo/vision/resnet.py)
against the JAX package's, on the CPU: parameter names and shapes, the
weights carried over by load_mxnet_tpu_params (BatchNorm running
statistics included), and the logits.

Tolerances for the logits, of their largest magnitude: 1e-5 in predict
mode (measured about 1e-6 for ResNet-50 at (1, 32, 32, 3)): dozens of
float32 convolutions and BatchNorms, each summed in another order by each
package.  In train mode BatchNorm divides by the spread of two samples at
the deepest stages and so magnifies each package's float32 rounding, by
an amount that hangs on the host's vector unit: the small bottleneck net
gave 2e-5 of its largest logit on one host and 3.6e-4 on another.  So
both packages' train-mode logits are held against the port's own float64
logits (the JAX package in float64, with its BatchNorm's float32
``rsqrt`` widened, agrees with them to 1.4e-12): the JAX package's error
within 5e-4 of the largest logit, so that a port that computed another
function would show (its error was 2.2e-4 of it, 2.7e-4 of a 1.22
logit, on an AVX512 host: 5e-4 is about twice that), and
the port's within twice the JAX package's plus one float32 unit in the
last place at that scale (``test_utils.within_float64_rounding``).  The
running statistics: 1e-5.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.test_utils import within_float64_rounding


def _jax_net(make, shape, seed=0):
    mx.random.seed(seed)
    net = make()
    net.initialize()
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    out = net(mx.nd.array(x)).asnumpy()
    params = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    return net, params, x, out


def _close(got, want, tol=1e-5):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def test_resnet50_v1_loads_jax_parameters_and_gives_its_logits():
    jnet, params, x, want = _jax_net(
        lambda: jvision.resnet50_v1(layout="NHWC"), (1, 32, 32, 3))
    net = tvision.resnet50_v1(layout="NHWC", device="cpu")
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes == {k: v.shape for k, v in params.items()}
    # 53 convolutions, each with a BatchNorm of four tensors; a bias on
    # the two 1x1 convolutions of each of the 16 blocks; the classifier
    assert len(shapes) == 53 + 53 * 4 + 2 * 16 + 2
    for name in ("features.4.0.body.0.weight", "features.4.0.body.0.bias",
                 "features.4.0.downsample.1.running_var", "output.weight"):
        assert name in shapes
    assert "features.4.0.body.3.bias" not in shapes  # the 3x3 has none
    # the same parameters train; the running statistics do not
    trains = {k for k, p in jnet._collect_params_with_prefix().items()
              if p.grad_req != "null"}
    assert trains == {k for k, p in net._collect_params_with_prefix().items()
                      if p.requires_grad and p.grad_req != "null"}
    assert not any("running" in k for k in trains)
    load_mxnet_tpu_params(net, params)
    assert torch.equal(
        getattr(net.features, "1")._parameters["running_var"].detach(),
        torch.from_numpy(params["features.1.running_var"]))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("make,shape", [
    (lambda v: v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1],
                          [16, 32, 64, 128, 256], classes=10,
                          layout="NHWC"), (2, 32, 32, 3)),
    (lambda v: v.ResNetV1(v.BasicBlockV1, [2, 1, 1, 1],
                          [8, 8, 16, 32, 64], classes=5, thumbnail=True,
                          layout="NHWC"), (2, 16, 16, 3)),
])
def test_small_resnets_match_jax_in_predict_and_train_mode(make, shape):
    jnet, params, x, want = _jax_net(lambda: make(jvision), shape)
    kwargs = {"device": "cpu"}
    net = load_mxnet_tpu_params(make(_Device(tvision, kwargs)), params)
    with torch.no_grad():
        _close(net(torch.from_numpy(x)).numpy(), want)
    # train mode: batch statistics, and the running ones updated
    with jag.record():
        want = jnet(mx.nd.array(x)).asnumpy()
    with tag.record():
        got = net(torch.from_numpy(x)).detach().numpy()
    net64 = load_mxnet_tpu_params(make(_Device(tvision, kwargs)),
                                  params).double()
    with tag.record():
        ref = net64(torch.from_numpy(x).double()).detach().numpy()
    e_port, e_jax, limit = within_float64_rounding(got, want, ref)
    assert e_jax <= 5e-4 * float(np.abs(ref).max()), e_jax
    assert e_port <= limit, (e_port, e_jax)
    jstats = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()
              if "running" in k}
    for k, v in jstats.items():
        np.testing.assert_allclose(net.state_dict()[k].numpy(), v,
                                   rtol=1e-5, atol=1e-5)


class _Device:
    """``vision`` with ``kwargs`` added to every ResNetV1 made through it."""

    def __init__(self, mod, kwargs):
        self._mod, self._kwargs = mod, kwargs

    def __getattr__(self, name):
        attr = getattr(self._mod, name)
        if name == "ResNetV1":
            return lambda *a, **k: attr(*a, **k, **self._kwargs)
        return attr


def _grads_of(jnet, net, x, train):
    """Outputs and gradients of ``sum(out^2)`` in both packages, recorded
    in train mode (batch statistics) or predict mode (running ones)."""
    xj = mx.nd.array(x)
    with jag.record(train_mode=train):
        jout = jnet(xj)
        (jout * jout).sum().backward()
    xt = torch.from_numpy(x)
    with tag.record(train_mode=train):
        tout = net(xt)
    tag.backward((tout * tout).sum())
    jg = {k: p.grad().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()
          if p.grad_req != "null"}
    tg = {k: p.grad.numpy()
          for k, p in net._collect_params_with_prefix().items()
          if p.requires_grad and p.grad is not None}
    return tout.detach().numpy(), jout.asnumpy(), tg, jg


@pytest.mark.parametrize("make,shape", [
    (lambda v, **kw: v.resnet18_v1(classes=6, **kw), (2, 3, 64, 64)),
    (lambda v, **kw: v.ResNetV1(v.BottleneckV1, [1], [8, 32], classes=4,
                                **kw), (2, 3, 16, 16)),
], ids=["resnet18_v1", "bottleneck-one-stage"])
@pytest.mark.parametrize("train", [False, True], ids=["predict", "train"])
def test_nchw_resnets_match_jax_outputs_and_gradients(make, shape, train):
    """The default layout, NCHW (OIHW weights, BatchNorm over axis 1):
    logits and every parameter's gradient against the JAX zoo's.  The
    gradients are held to 1e-4 of each one's largest magnitude (1e-3 in
    train mode, where BatchNorm's division by the batch's spread at the
    deepest stages magnifies the float32 differences; biases that feed a
    BatchNorm have a true gradient of 0 and are compared on the scale of
    the layer's weight gradient).  ResNet-18 runs at 64 x 64, so that its
    last stage's BatchNorm sees 2 x 2 maps of two samples."""
    jnet, params, x, want = _jax_net(lambda: make(jvision), shape)
    net = load_mxnet_tpu_params(make(tvision, device="cpu"), params)
    assert net.features[0].weight.shape[1:] == (3, 7, 7)  # OIHW
    with torch.no_grad():
        _close(net(torch.from_numpy(x)).numpy(), want)
    got, jout, tg, jg = _grads_of(jnet, net, x, train)
    _close(got, jout, 1e-4 if train else 1e-5)
    assert set(tg) == set(jg)
    tol = 1e-3 if train else 1e-4
    for k, want_g in jg.items():
        scale = float(np.abs(want_g).max())
        if k.endswith("bias") and k[:-4] + "weight" in jg:
            scale = max(scale, float(np.abs(jg[k[:-4] + "weight"]).max()))
        assert tg[k].shape == want_g.shape, k
        assert float(np.abs(tg[k] - want_g).max()) <= tol * scale, k


def test_model_zoo_entry_points():
    net = tvision.resnet18_v1(layout="NHWC", classes=4, device="cpu")
    assert isinstance(net, tvision.ResNetV1)
    assert net.output.weight.shape == (4, 512)
    # the default layout is NCHW: OIHW weights, BatchNorm over axis 1
    net = tvision.resnet50_v1(device="cpu")
    assert net.features[0].weight.shape == (64, 3, 7, 7)
    assert net.features[1]._axis == 1
    with pytest.raises(MXNetError, match="NHWC"):
        tvision.resnet50_v1(layout="NCWH", device="cpu")
    # v2 is ported too (tests/test_torch_resnet_v2.py); no v3
    assert isinstance(tvision.get_resnet(2, 50, layout="NHWC", device="cpu"),
                      tvision.ResNetV2)
    with pytest.raises(ValueError, match="1 or 2"):
        tvision.get_resnet(3, 50, layout="NHWC", device="cpu")
    with pytest.raises(ValueError, match="no ResNet of 26 layers"):
        tvision.get_resnet(1, 26, layout="NHWC", device="cpu")
