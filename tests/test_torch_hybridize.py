"""HybridBlock.hybridize() of the port against eager execution and the JAX
package's hybridized blocks, on the CPU.

On the CPU a hybridized block runs eagerly under the same per-signature
cache and bookkeeping as on the card (where each entry is a captured CUDA
graph, held against eager execution by chip_smoke.py phases 5 and 6), so
its results equal the unhybridized block's bit for bit.

A small ResNetV1 (BottleneckV1, one block per stage, widths 16-256, 10
classes, NHWC) is initialised in JAX and carried over by
load_mxnet_tpu_params.  Tolerances against the JAX package's hybridized
block, of the largest magnitude: 1e-5 for the logits in predict mode
(float32 convolutions and BatchNorms summed in another order by each
package), 1e-4 in train mode, where BatchNorm divides by the spread of a
small batch at the deepest stages (tests/test_torch_resnet.py measured
2e-5); the running statistics 1e-5.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon.model_zoo.vision.resnet import BottleneckV1 as JBottle
from mxnet_tpu.gluon.model_zoo.vision.resnet import ResNetV1 as JResNetV1
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1

LAYERS, CHANNELS, CLASSES = [1, 1, 1, 1], [16, 32, 64, 128, 256], 10
SHAPE = (4, 32, 32, 3)


@pytest.fixture(scope="module")
def jax_net():
    mx.random.seed(3)
    net = JResNetV1(JBottle, LAYERS, CHANNELS, classes=CLASSES,
                    layout="NHWC")
    net.initialize()
    net(mx.nd.zeros((1,) + SHAPE[1:]))
    return net, {k: p.data().asnumpy()
                 for k, p in net._collect_params_with_prefix().items()}


def _port(params):
    return load_mxnet_tpu_params(
        ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=CLASSES,
                 layout="NHWC", device="cpu"), params)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*SHAPE).astype(np.float32),
            rng.randint(0, CLASSES, (SHAPE[0],)).astype(np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(
        np.abs(want).max())


def _running(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()
            if "running" in k}


def test_hybridized_forward_equals_eager_and_jax(jax_net):
    jnet, params = jax_net
    jnet.hybridize()
    x, _ = _batch()
    want = jnet(mx.nd.array(x)).asnumpy()
    eager, hyb = _port(params), _port(params)
    hyb.hybridize()
    got = hyb(torch.from_numpy(x))
    assert torch.equal(got, eager(torch.from_numpy(x)))
    _close(got.numpy(), want, 1e-5)
    assert len(hyb._cached_graphs) == 1


def test_train_mode_running_statistics_move_once_per_call(jax_net):
    jnet, params = jax_net
    x, _ = _batch(1)
    eager, hyb = _port(params), _port(params)
    hyb.hybridize()
    jnet.hybridize()
    for _ in range(2):
        with jag.record():
            want = jnet(mx.nd.array(x)).asnumpy()
        with tag.record():
            got = hyb(torch.from_numpy(x))
            ref = eager(torch.from_numpy(x))
        assert torch.equal(got, ref)
        _close(got.detach().numpy(), want, 1e-4)
        for k, v in _running(hyb).items():
            assert torch.equal(v, _running(eager)[k]), k
    jstats = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()
              if "running" in k}
    for k, v in _running(hyb).items():
        np.testing.assert_allclose(v.numpy(), jstats[k], rtol=1e-5,
                                   atol=1e-5)
    (graph,) = hyb._cached_graphs.values()
    assert graph.calls == 2 and graph.recording


def test_gradients_under_record_equal_eager(jax_net):
    _, params = jax_net
    x, y = _batch(2)
    nets = [_port(params), _port(params)]
    nets[1].hybridize()
    grads = []
    for net in nets:
        with tag.record():
            loss = tloss.SoftmaxCrossEntropyLoss()(net(torch.from_numpy(x)),
                                                   torch.from_numpy(y))
        tag.backward(loss)
        grads.append({k: p.grad.clone() for k, p in
                      net._collect_params_with_prefix().items()
                      if p.grad is not None})
    trainable = [k for k, p in nets[0]._collect_params_with_prefix().items()
                 if p.grad_req != "null"]
    assert sorted(grads[0]) == sorted(grads[1]) == sorted(trainable)
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


def test_one_cache_entry_per_signature_and_mode(jax_net):
    _, params = jax_net
    net = _port(params)
    net.hybridize(static_alloc=True, static_shape=True)
    x = torch.from_numpy(_batch()[0])
    net(x)
    net(x)
    assert len(net._cached_graphs) == 1
    assert next(iter(net._cached_graphs.values())).calls == 2
    net(x[:2])                                  # another shape
    net(x.double().float()[:, :16, :16])        # and another
    with tag.record():                          # train mode, recording
        net(x)
    with tag.record(train_mode=False):          # predict mode, recording
        net(x)
    with tag.train_mode():                      # train mode, no recording
        net(x)
    keys = list(net._cached_graphs)
    assert len(keys) == 6 and len(set(keys)) == 6
    assert {(k[2], k[3]) for k in keys} == {(False, False), (True, True),
                                           (False, True), (True, False)}
    # the children run inside their parent's program, with no cache of
    # their own
    assert all(not getattr(m, "_cached_graphs", {}) for m in net.modules()
               if m is not net)
    assert all(m._active for m in net.modules()
               if isinstance(m, tnn.HybridSequential))
    net.hybridize()
    assert net._cached_graphs == {}
    net(x)
    net.cast("float32")
    assert net._cached_graphs == {}
    net.hybridize(active=False)
    net(x)
    assert net._cached_graphs == {}


def test_hybridized_block_takes_tensor_arguments_only():
    net = tnn.Dense(3, in_units=4, device="cpu").initialize()
    net.hybridize()
    with pytest.raises(MXNetError, match="tensors as positional"):
        net(np.ones((2, 4), np.float32))
    out = net(torch.ones(2, 4))
    assert out.shape == (2, 3)


def test_cast_keeps_batchnorm_statistics_float32():
    """As the JAX package's cast: a half type casts the weights, while a
    BatchNorm layer stays float32."""
    net = tnn.HybridSequential(device="cpu")
    net.add(tnn.Dense(4, in_units=3, device="cpu"),
            tnn.BatchNorm(axis=-1, in_channels=4, device="cpu"))
    net.initialize()
    w = getattr(net, "0")._parameters["weight"]
    net.cast("bfloat16")
    assert getattr(net, "0")._parameters["weight"] is w \
        and w.dtype == torch.bfloat16
    assert {p.dtype for p in getattr(net, "1").parameters()} == {
        torch.float32}
    net.cast(np.float16)
    assert w.dtype == torch.float16


def test_cast_of_a_child_drops_the_parents_programs():
    """A child's cast replaces the storage its parameters had, which the
    parent's captured graphs read: the parent's cache entry, and a
    training step's graphs, are made anew."""
    from mxnet_tpu_torch.parallel import GluonTrainStep

    net = tnn.HybridSequential(device="cpu")
    net.add(tnn.Dense(4, in_units=3, device="cpu"),
            tnn.Dense(2, in_units=4, device="cpu"))
    net.initialize()
    step = GluonTrainStep(net, tloss.SoftmaxCrossEntropyLoss(), device="cpu")
    step.graphs["stale"] = object()
    net.hybridize()
    x = torch.from_numpy(np.random.RandomState(0).rand(5, 3)
                         .astype(np.float32))
    net(x)
    (old,) = net._cached_graphs.values()
    child = getattr(net, "0")
    child.cast("bfloat16")
    child.cast("float32")
    got = net(x)
    (new,) = net._cached_graphs.values()
    assert new is not old and new.calls == 1
    net.hybridize(active=False)
    assert torch.equal(got, net(x))
    assert step._graphs() == {}
