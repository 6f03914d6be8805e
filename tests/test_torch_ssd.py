"""The SSD networks of the port (gluon/model_zoo/ssd.py) against the JAX
package on the CPU: the JAX example's TinySSD (example/ssd/train.py,
imported here) through its training loop, and SSD300 over the reduced
VGG16 at a sixteenth of its widths against the same network built from
the JAX package's Gluon layers.

Tolerances (each relative, and absolute scaled by the largest magnitude
when it exceeds 1):
- TinySSD's outputs, losses and every gradient: 1e-5 (float32
  convolutions and BatchNorm summed in another order in each package);
  its parameters after three Adam steps: 1e-4 (Adam divides by the root
  of the second moment, which magnifies the gradients' last bits where
  they are small), but for the elements whose gradient came within 1e-5
  of the largest of 0 at some step, held to three
  learning rates of travel: Adam's normalised step turns their rounding
  into up to a learning rate a step.  The biases of the convolutions
  that feed a BatchNorm have a true gradient of 0: their gradients are
  held to be rounding noise in both packages, and the Adam steps hold
  them fixed in both;
- SSD300's outputs and gradients: 1e-4 (some twenty layers of float32
  sums, each in its own order).
The targets' classes and masks and the detections' classes are equal.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgl
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray import contrib as jndc
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.model_zoo import ssd as tssd
from mxnet_tpu_torch.ops import contrib as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    spec = importlib.util.spec_from_file_location(
        "ssd_example_train", os.path.join(REPO, "example", "ssd",
                                          "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


def _scenes(seed, n, hw, classes):
    """Scenes of the port's synthetic_scenes (the example's make_scenes with
    a colour a class), normalised as ImageDetIter's mean and std do."""
    images, label = tssd.synthetic_scenes(np.random.RandomState(seed), n, hw,
                                          classes, max_objs=2)
    return tssd.normalize(torch.from_numpy(images)).numpy(), label


def _jparams(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _jax_step(net, data, label, l1, trainer=None):
    with mx.autograd.record():
        anchor, cls_pred, loc_pred = net(data)
        loc_t, loc_m, cls_t = jndc.MultiBoxTarget(
            anchor, label, cls_pred.transpose((0, 2, 1)),
            negative_mining_ratio=3.0)
        log_p = mx.nd.log_softmax(cls_pred, axis=-1)
        ce = -mx.nd.pick(log_p, mx.nd.clip(cls_t, 0, 1e9), axis=-1)
        valid = (cls_t >= 0).astype("float32")
        lc = (ce * valid).sum() / mx.nd.clip(valid.sum(), 1.0, 1e18)
        ll = l1(loc_pred * loc_m, loc_t * loc_m)
        loss = lc + 5.0 * ll
    loss.backward()
    if trainer is not None:
        trainer.step(data.shape[0])
    return [o.asnumpy() for o in (anchor, cls_pred, loc_pred, loc_t, loc_m,
                                  cls_t, lc, ll)]


def _port_step(net, data, label, l1, trainer=None):
    with autograd.record():
        anchor, cls_pred, loc_pred = net(data)
        loc_t, loc_m, cls_t = tc.multibox_target(
            anchor, label, cls_pred.transpose(1, 2),
            negative_mining_ratio=3.0)
        lc = tssd.cls_loss(cls_pred, cls_t)
        ll = l1(loc_pred * loc_m, loc_t * loc_m)
        loss = lc + 5.0 * ll
    autograd.backward(loss)
    if trainer is not None:
        trainer.step(data.shape[0])
    return [o.detach().numpy() for o in (anchor, cls_pred, loc_pred, loc_t,
                                         loc_m, cls_t, lc, ll)]


def _tiny_pair(data):
    ex = _example()
    mx.random.seed(4)
    jnet = ex.TinySSD(num_classes=3)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(data))
    tnet = tssd.TinySSD(num_classes=3, device="cpu")
    params = _jparams(jnet)
    assert list(tnet.state_dict(keep_vars=True)) == list(params)
    load_mxnet_tpu_params(tnet, params)
    return jnet, tnet


def test_tiny_ssd_matches_the_jax_example():
    data, label = _scenes(0, 4, 64, 3)
    jnet, tnet = _tiny_pair(data)
    want = _jax_step(jnet, mx.nd.array(data), mx.nd.array(label),
                     jgl.loss.L1Loss())
    got = _port_step(tnet, torch.from_numpy(data), torch.from_numpy(label),
                     gluon.loss.L1Loss())
    names = ["anchor", "cls_pred", "loc_pred", "loc_t", "loc_m", "cls_t",
             "cls loss", "loc loss"]
    assert got[0].shape == (1, 16 * 16 * 4 + 8 * 8 * 4, 4)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if name in ("loc_m", "cls_t"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _close(g, w, 1e-5, name)
    assert (want[5] > 0).any() and (want[5] == -1).any()
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()
              if p.grad_req != "null"}
    tgrads = {k: p.grad.numpy() for k, p in tnet.collect_params().items()
              if p.requires_grad}
    assert set(tgrads) == set(jgrads) and len(tgrads) == 24
    top = max(float(np.abs(w).max()) for w in jgrads.values())
    for k, w in jgrads.items():
        if k in BN_FED_BIASES:
            # true gradient 0: both are rounding noise, far below the rest
            assert max(np.abs(w).max(), np.abs(tgrads[k]).max()) \
                < 1e-4 * top, k
            continue
        _close(tgrads[k], w, 1e-5, k)


def test_tiny_ssd_three_adam_steps_match_the_jax_example():
    data, label = _scenes(1, 4, 64, 3)
    jnet, tnet = _tiny_pair(data)
    # the biases of the convolutions that feed a BatchNorm have a true
    # gradient of 0, and Adam turns their rounding noise into steps of up
    # to the learning rate, of either sign: both packages hold them fixed
    for name in BN_FED_BIASES:
        jnet._collect_params_with_prefix()[name].grad_req = "null"
        tnet.collect_params()[name].grad_req = "null"
    small = {}
    jtr = jgl.Trainer(jnet.collect_params(), "adam", {"learning_rate": 2e-3})
    ttr = gluon.Trainer(tnet.collect_params(), "adam",
                        {"learning_rate": 2e-3})
    jl1, tl1 = jgl.loss.L1Loss(), gluon.loss.L1Loss()
    for step in range(3):
        w = _jax_step(jnet, mx.nd.array(data), mx.nd.array(label), jl1, jtr)
        g = _port_step(tnet, torch.from_numpy(data), torch.from_numpy(label),
                       tl1, ttr)
        _close(g[6], w[6], 1e-4, "cls loss, step %d" % step)
        _close(g[7], w[7], 1e-4, "loc loss, step %d" % step)
        grads = {k: p.grad().asnumpy()
                 for k, p in jnet._collect_params_with_prefix().items()
                 if p.grad_req != "null"}
        top = max(float(np.abs(v).max()) for v in grads.values())
        for k, v in grads.items():
            # an exact 0 (an anchor's head channel no target reached) is
            # exact in both, and Adam leaves the element where it was
            small[k] = small.get(k, False) | ((np.abs(v) < 1e-5 * top)
                                              & (v != 0))
    start = _jparams(_tiny_pair(data)[0])
    for k, v in _jparams(jnet).items():
        got = tnet.collect_params()[k].detach().numpy()
        # where a gradient was within rounding of 0, Adam's normalised
        # step turns the last bits into up to a learning rate a step
        mask = small.get(k, np.zeros(v.shape, bool))
        # so few that a fault in a whole leaf cannot hide behind the mask
        # (the largest share, loc2.weight's, is 1.7 %)
        assert mask.mean() < 0.02, (k, mask.mean())
        _close(got[~mask], v[~mask], 1e-4, k)
        assert np.abs(got - start[k])[mask].max(initial=0) <= 3 * 2.001e-3


def test_tiny_ssd_detections_match_the_jax_example():
    """The example's evaluate(): softmax over the classes, MultiBoxDetection
    at nms_threshold 0.45, in predict mode."""
    data, _ = _scenes(2, 4, 64, 3)
    jnet, tnet = _tiny_pair(data)
    anchor, cls_pred, loc_pred = jnet(mx.nd.array(data))
    probs = mx.nd.softmax(cls_pred, axis=-1).transpose((0, 2, 1))
    want = jndc.MultiBoxDetection(probs, loc_pred, anchor,
                                  nms_threshold=0.45).asnumpy()
    tanchor, tcls, tloc = tnet(torch.from_numpy(data))
    got = tc.multibox_detection(torch.softmax(tcls, -1).transpose(1, 2),
                                tloc, tanchor, nms_threshold=0.45).numpy()
    assert got.shape == (4, 1280, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (want[..., 0] >= 0).any() and (want[..., 0] < 0).any()
    _close(got, want, 1e-5)


BN_FED_BIASES = ("backbone.0.bias", "backbone.4.bias", "scale1.0.bias",
                 "down.0.bias")


class _JaxSSD300(jgl.Block):
    """SSD300 from the JAX package's Gluon layers, with the port's
    structural names."""

    def __init__(self, num_classes, d):
        super().__init__()
        cfg = tssd.SSD300_CONFIG
        widths = [64 // d, 128 // d, 256 // d, 512 // d, 512 // d]
        layers = [2, 2, 3, 3, 3]

        def conv(f, k=3, stride=1, pad=1, dilation=1):
            return [jnn.Conv2D(f, k, strides=stride, padding=pad,
                               dilation=dilation), jnn.Activation("relu")]

        with self.name_scope():
            self.features = jnn.Sequential()
            for stage in range(4):
                if stage:
                    self.features.add(jnn.MaxPool2D(2, 2,
                                                    ceil_mode=stage == 3))
                for _ in range(layers[stage]):
                    self.features.add(*conv(widths[stage]))
            self.fc = jnn.Sequential()
            self.fc.add(jnn.MaxPool2D(2, 2))
            for _ in range(layers[4]):
                self.fc.add(*conv(widths[4]))
            self.fc.add(jnn.MaxPool2D(3, 1, 1))
            self.fc.add(*conv(1024 // d, pad=6, dilation=6),
                        *conv(1024 // d, k=1, pad=0))
            self.l2_scale = self.params.get(
                "l2_scale", shape=(1, widths[3], 1, 1),
                init=mx.init.Constant(20.0))
            self.extras = jnn.Sequential()
            for f, s, p in zip(cfg["extra_filters"], cfg["extra_strides"],
                               cfg["extra_pads"]):
                block = jnn.Sequential()
                block.add(*conv(f // d // 2, k=1, pad=0),
                          *conv(f // d, stride=s, pad=p))
                self.extras.add(block)
            self.cls_heads = jnn.Sequential()
            self.loc_heads = jnn.Sequential()
            for sizes, ratios in zip(cfg["sizes"], cfg["ratios"]):
                a = len(sizes) + len(ratios) - 1
                self.cls_heads.add(jnn.Conv2D(a * (num_classes + 1), 3,
                                              padding=1))
                self.loc_heads.add(jnn.Conv2D(a * 4, 3, padding=1))
        self.num_classes = num_classes

    def forward(self, x):
        cfg = tssd.SSD300_CONFIG
        x = self.features(x)
        feats = [mx.nd.L2Normalization(x, mode="channel")
                 * self.l2_scale.data()]
        x = self.fc(x)
        feats.append(x)
        for block in self.extras:
            x = block(x)
            feats.append(x)
        anchors, cls_preds, loc_preds = [], [], []
        for i, f in enumerate(feats):
            anchors.append(jndc.MultiBoxPrior(
                f, sizes=cfg["sizes"][i], ratios=cfg["ratios"][i],
                steps=(cfg["steps"][i], cfg["steps"][i])))
            b = f.shape[0]
            cls_preds.append(self.cls_heads[i](f).transpose(
                (0, 2, 3, 1)).reshape((b, -1, self.num_classes + 1)))
            loc_preds.append(self.loc_heads[i](f).transpose(
                (0, 2, 3, 1)).reshape((b, -1)))
        return (mx.nd.concat(*anchors, dim=1), mx.nd.concat(*cls_preds, dim=1),
                mx.nd.concat(*loc_preds, dim=1))


@pytest.mark.parametrize("seed", [0])
def test_ssd300_matches_the_jax_layers(seed):
    data, label = _scenes(seed + 5, 2, 300, 20)
    mx.random.seed(seed)
    jnet = _JaxSSD300(20, 16)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(data))
    tnet = tssd.SSD300(20, width_divisor=16, device="cpu")
    params = _jparams(jnet)
    assert list(tnet.state_dict(keep_vars=True)) == list(params)
    load_mxnet_tpu_params(tnet, params)
    maps = []
    hook = [m.register_forward_hook(lambda m, a, out: maps.append(
        tuple(out.shape[2:]))) for m in tnet.cls_heads]
    want = _jax_step(jnet, mx.nd.array(data), mx.nd.array(label),
                     jgl.loss.L1Loss())
    got = _port_step(tnet, torch.from_numpy(data), torch.from_numpy(label),
                     gluon.loss.L1Loss())
    for h in hook:
        h.remove()
    assert maps == [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    assert got[0].shape == (1, 8732, 4) and got[1].shape == (2, 8732, 21)
    assert got[2].shape == (2, 8732 * 4)
    names = ["anchor", "cls_pred", "loc_pred", "loc_t", "loc_m", "cls_t",
             "cls loss", "loc loss"]
    for name, g, w in zip(names, got, want):
        if name in ("loc_m", "cls_t"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _close(g, w, 1e-4, name)
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tgrads = {k: p.grad.numpy() for k, p in tnet.collect_params().items()}
    assert set(tgrads) == set(jgrads)
    for k, w in jgrads.items():
        _close(tgrads[k], w, 1e-4, k)


def test_ssd300_widths_and_anchors_at_full_width():
    """The published widths on the meta device: the heads' widths, fc6's
    dilation and the anchors a map."""
    net = tssd.SSD300(20, device="meta")
    convs = [(c._kwargs["num_filter"], c._kwargs["kernel"],
              c._kwargs["dilate"]) for c in net.fc
             if isinstance(c, gluon.nn.Conv2D)]
    assert convs[-2:] == [(1024, (3, 3), (6, 6)), (1024, (1, 1), (1, 1))]
    assert [h._kwargs["num_filter"] for h in net.cls_heads] == [
        84, 126, 126, 126, 84, 84]
    assert [h._kwargs["num_filter"] for h in net.loc_heads] == [
        16, 24, 24, 24, 16, 16]
    assert tuple(net.l2_scale.shape) == (1, 512, 1, 1)
