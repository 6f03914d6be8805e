"""The port's GluonTrainStep against the JAX package's, on the CPU.

A small ResNetV1 (BottleneckV1, one block per stage, widths 16-256, 10
classes, NHWC) is initialised in JAX and carried over by
load_mxnet_tpu_params; both packages then train it on one fixed
(4, 32, 32, 3) batch with SGD (lr 0.1, momentum 0.9, wd 1e-4), the
bench's hyperparameters.  The JAX step runs with MXTPU_PALLAS_CONV_DW=1 and
MXTPU_PALLAS_POOL_BWD=1, so its weight-gradients and max-pool gradient go
through the Pallas kernels in interpret mode (K1a/K1b, K2), as the port's
go through their plain versions here.

Each step of the port starts from the JAX package's state before that
step (weights, momentum, running statistics) and is held against the JAX
package's state after it.  Two free-running trajectories cannot be
compared over more than two steps at this size: a relative perturbation
of 1e-7 in the weights alone grows to 1e-3 by the third step and to 10 %
by the fourth in the port itself (batch statistics over four samples,
and ReLU and max-pool decisions that flip), so the test feeds each step
the same state instead.

Tolerances:
- float32, 5 steps: the loss within 1e-5 relative (measured: equal to
  7.6e-7); every weight and running statistic within 1e-3 of its largest
  magnitude, at least 1e-3; every momentum tensor (the step's accumulated
  gradient) within 1e-3 of its largest magnitude, at least 1e-3 of the
  step's largest momentum (measured: 2.2e-4).  The floors are there for
  the biases of the convolutions that feed a BatchNorm: their true
  gradient is 0 and their values are rounding noise;
- bfloat16 compute, 3 steps.  At this size bf16 rounding alone moves
  the JAX package's own gradients by 30-80 % (L2 over all tensors) from
  the float32 ones of the same state, and its loss by 0.03-0.05, so the
  port is held to bf16 noise: the loss within 0.1 of the JAX package's
  (measured: 0 to 0.0625, eight bf16 steps at 1.5); the momentum no
  farther from the JAX package's (L2 over all tensors) than twice the
  distance of the port's float32 step from it (measured: 0.6 to 1.4 times;
  independent noise of equal size in each package gives about 1.4); the
  running statistics within 5e-2 of their scale (measured: 0.008 to
  0.024): they average activations that carry bf16 noise, and the port
  rounds the batch statistics to bf16 as the JAX code is written, where
  XLA's compiled step keeps them in float32 (its excess precision);
- make_chained(1) from the JAX package's initial state against the JAX
  package's make_chained(1), and make_chained(2) against the JAX
  package's make_chained(1) run from the port's own state after its
  first step (the state its chained second step starts from, as above):
  the tolerances of the float32 steps above;
- make_chained(n) against n __call__ steps of the port on the CPU: equal
  bit for bit (the same eager code);
- float16 compute, one step from the JAX package's initial state (the
  step that raised before the port took float16): the loss within 1e-2
  of the JAX package's (measured: 0.002, one float16 step at 3.1); the
  momentum as the bf16 steps hold it (measured: 0.03 times the float32
  step's distance); the running statistics within 1e-2 of their scale
  (measured: 8e-4).
"""

import types

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.ops.nn as jops
from mxnet_tpu import gluon as jgl
from mxnet_tpu.gluon.model_zoo.vision.resnet import BottleneckV1 as JBottle
from mxnet_tpu.gluon.model_zoo.vision.resnet import ResNetV1 as JResNetV1
from mxnet_tpu.parallel.gluon_step import GluonTrainStep as JStep
from mxnet_tpu.parallel.mesh import create_mesh
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.ops import conv_dw as port_dw
from mxnet_tpu_torch.ops import pool_bwd as port_pool
from mxnet_tpu_torch.parallel import GluonTrainStep

LAYERS, CHANNELS, CLASSES = [1, 1, 1, 1], [16, 32, 64, 128, 256], 10
HYPER = {"lr": 0.1, "momentum": 0.9, "wd": 1e-4}


def _jax_params():
    mx.random.seed(11)
    net = JResNetV1(JBottle, LAYERS, CHANNELS, classes=CLASSES,
                    layout="NHWC")
    net.initialize()
    net(mx.nd.zeros((1, 32, 32, 3)))
    return net, {k: p.data().asnumpy()
                 for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    return (rng.rand(4, 32, 32, 3).astype(np.float32),
            rng.randint(0, CLASSES, (4,)).astype(np.int32))


def _run_jax(monkeypatch, x, y, steps, compute_dtype):
    """The JAX step's states: [(params incl. running stats, momentum)]
    before each step and after the last, and the losses."""
    import jax

    monkeypatch.setenv("MXTPU_PALLAS_CONV_DW", "1")
    monkeypatch.setenv("MXTPU_PALLAS_POOL_BWD", "1")
    jops._nhwc_conv2d_pallas_dw.cache_clear()
    jops._nhwc_maxpool2d_pallas_bwd.cache_clear()
    net, params = _jax_params()
    mesh = create_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])
    step = JStep(net, jgl.loss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                 compute_dtype=compute_dtype, **HYPER)
    names = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    train_names = [names[id(p)] for p in step.trainable]
    aux_names = [names[id(p)] for p in step.aux]

    def state():
        vals = dict(zip(train_names + aux_names,
                        (np.asarray(v) for v in step.train_vals
                         + step.aux_vals)))
        mom = dict(zip(train_names, (np.asarray(s) for s in step.opt_state)))
        return vals, mom

    xs, ys = step.put_batch(x, y)
    states, losses = [state()], []
    for _ in range(steps):
        losses.append(float(np.asarray(step(xs, ys))))
        states.append(state())
    # the Pallas-routed conv and pool were traced into the step
    assert jops._nhwc_conv2d_pallas_dw.cache_info().currsize > 0
    assert jops._nhwc_maxpool2d_pallas_bwd.cache_info().currsize > 0
    return states, losses


def _port_step(params, compute_dtype):
    net = load_mxnet_tpu_params(
        ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=CLASSES,
                 layout="NHWC", device="cpu"), params)
    return net, GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               device="cpu", compute_dtype=compute_dtype,
                               **HYPER)


def _port_from(state, compute_dtype, x, y):
    """One step of the port from a JAX state: the step, its loss, the
    weights and running statistics after it, and the momentum."""
    vals, mom = state
    net, step = _port_step(vals, compute_dtype)
    names = {id(p): k for k, p in net.collect_params().items()}
    train_names = [names[id(p)] for p in step.trainable]
    with torch.no_grad():
        for s, name in zip(step.opt_state, train_names):
            s.copy_(torch.from_numpy(mom[name]))
    loss = step(x, y)
    return (step, float(loss.float()),
            {k: v.detach().numpy() for k, v in net.state_dict().items()},
            {n: s.numpy() for n, s in zip(train_names, step.opt_state)})


def _worst(got, want, floor):
    """The largest max |got - want| over max(max |want|, floor)."""
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k] - w).max())
               / max(float(np.abs(w).max()), floor) for k, w in want.items())


def _l2(got, want):
    """|got - want| / |want| over all tensors together."""
    num = sum(float(((got[k].astype(np.float64) - w) ** 2).sum())
              for k, w in want.items())
    return (num / sum(float((w.astype(np.float64) ** 2).sum())
                      for w in want.values())) ** 0.5


def test_float32_steps_match_jax(monkeypatch, batch):
    x, y = batch
    states, losses = _run_jax(monkeypatch, x, y, 5, None)
    for k in range(5):
        step, loss, vals, mom = _port_from(states[k], None, x, y)
        want_vals, want_mom = states[k + 1]
        big = max(float(np.abs(m).max()) for m in want_mom.values())
        assert abs(loss - losses[k]) <= 1e-5 * abs(losses[k]), k
        assert _worst(vals, want_vals, 1e-3) < 1e-3, k
        assert _worst(mom, want_mom, 1e-3 * big) < 1e-3, k
    assert np.isfinite(float(step.last_grad_norm))
    step.sync_to_params()  # nothing to write back: the masters are the block's


def test_bfloat16_steps_match_jax(monkeypatch, batch):
    x, y = batch
    states, losses = _run_jax(monkeypatch, x, y, 3, "bfloat16")
    for k in range(3):
        step, loss, vals, mom = _port_from(states[k], "bfloat16", x, y)
        _, _, _, mom_f32 = _port_from(states[k], None, x, y)
        want_vals, want_mom = states[k + 1]
        assert abs(loss - losses[k]) <= 0.1, k
        assert _l2(mom, want_mom) <= 2 * _l2(mom_f32, want_mom), k
        stats = {n: v for n, v in want_vals.items() if "running" in n}
        assert _worst({n: vals[n] for n in stats}, stats, 1e-3) < 5e-2, k
        # the masters and the running statistics stay float32
        assert all(p.dtype == torch.float32
                   for p in step.trainable + step.aux)


def test_float16_step_matches_jax(monkeypatch, batch):
    x, y = batch
    states, losses = _run_jax(monkeypatch, x, y, 1, "float16")
    step, loss, vals, mom = _port_from(states[0], "float16", x, y)
    _, _, _, mom_f32 = _port_from(states[0], None, x, y)
    want_vals, want_mom = states[1]
    assert abs(loss - losses[0]) <= 1e-2
    assert _l2(mom, want_mom) <= 2 * _l2(mom_f32, want_mom)
    stats = {n: v for n, v in want_vals.items() if "running" in n}
    assert _worst({n: vals[n] for n in stats}, stats, 1e-3) < 1e-2
    assert all(p.dtype == torch.float32 for p in step.trainable + step.aux)


def test_step_runs_no_kernel_on_cpu_and_updates_in_place(batch):
    x, y = batch
    _, params = _jax_params()
    net, step = _port_step(params, "bfloat16")
    w = net.output.weight
    before = w.detach().clone()
    rm = getattr(net.features, "1").running_mean.detach().clone()
    counts = (port_dw.conv_dw_pertap.launches,
              port_dw.conv_dw_im2col.launches, port_pool.maxpool_bwd.launches)
    loss = step(x, y)
    assert loss.dtype == torch.bfloat16 and loss.shape == ()
    assert step.trainable[-2] is w and not torch.equal(w.detach(), before)
    assert not torch.equal(getattr(net.features, "1").running_mean.detach(), rm)
    assert len(step.aux) == 2 * sum(1 for k in net.state_dict()
                                    if k.endswith("running_mean"))
    assert counts == (port_dw.conv_dw_pertap.launches,
                      port_dw.conv_dw_im2col.launches,
                      port_pool.maxpool_bwd.launches) == (0, 0, 0)


def test_step_rejects_parameters_on_another_device():
    net = ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=CLASSES,
                   layout="NHWC", device="cpu")
    with pytest.raises(MXNetError, match="lives on"):
        GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                       device="meta")
    with pytest.raises(MXNetError, match="floating"):
        GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                       device="cpu", compute_dtype="int8")


def _state(net, step):
    return ({k: v.detach().clone() for k, v in net.state_dict().items()},
            [s.clone() for s in step.opt_state])


def _one_cpu_mesh():
    import jax

    return create_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])


@pytest.mark.parametrize("mesh", [None, "jax-1", "duck-1"])
def test_bench_keywords_with_a_one_device_mesh(batch, mesh):
    """bench.py:677's keywords (mesh=, lr, momentum, wd, compute_dtype),
    with None, a JAX mesh of one device or any object whose ``devices``
    holds one device as the mesh, step bit for bit as the step built
    without a mesh."""
    mesh = {"jax-1": _one_cpu_mesh,
            "duck-1": lambda: types.SimpleNamespace(devices=["cpu"]),
            None: lambda: None}[mesh]()
    x, y = batch
    _, params = _jax_params()
    net_a, step_a = _port_step(params, "bfloat16")
    net_b = load_mxnet_tpu_params(
        ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=CLASSES,
                 layout="NHWC", device="cpu"), params)
    step_b = GluonTrainStep(net_b, gluon.loss.SoftmaxCrossEntropyLoss(),
                            mesh=mesh, lr=0.1, momentum=0.9, wd=1e-4,
                            compute_dtype="bfloat16", device="cpu")
    assert step_b.mesh is mesh
    for _ in range(2):
        assert torch.equal(step_b(x, y), step_a(x, y))
    (va, sa), (vb, sb) = _state(net_a, step_a), _state(net_b, step_b)
    assert all(torch.equal(vb[k], v) for k, v in va.items())
    assert all(torch.equal(b, a) for a, b in zip(sa, sb))


def test_mesh_is_third_and_device_keyword_only():
    """The reference's positional order: a device in the mesh's place, or
    positionally after compute_dtype, is refused; a mesh of two devices
    raises, naming multi-GPU training as not yet ported."""
    import jax

    net = ResNetV1(BottleneckV1, LAYERS, CHANNELS, classes=CLASSES,
                   layout="NHWC", device="cpu")
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(MXNetError, match="device="):
        GluonTrainStep(net, loss, "cpu")
    with pytest.raises(MXNetError, match="device="):
        GluonTrainStep(net, loss, torch.device("cpu"))
    with pytest.raises(TypeError):
        GluonTrainStep(net, loss, None, 0.1, 0.9, 1e-4, None, "cpu")
    two = create_mesh({"dp": 2}, devices=jax.devices("cpu")[:2])
    for mesh in (two, types.SimpleNamespace(devices=["cpu", "cpu"])):
        with pytest.raises(MXNetError, match="multi-GPU"):
            GluonTrainStep(net, loss, mesh=mesh, device="cpu")
    with pytest.raises(MXNetError, match="'devices'"):
        GluonTrainStep(net, loss, mesh=object(), device="cpu")
    with pytest.raises(MXNetError, match="'devices'"):
        GluonTrainStep(net, loss, mesh=["cpu"], device="cpu")
    step = GluonTrainStep(net, loss, _one_cpu_mesh(), 0.1, 0.9, 1e-4,
                          "bfloat16", device="cpu")
    assert step.device == torch.device("cpu")
    assert step._compute_dtype == torch.bfloat16


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_make_chained_equals_sequential_steps(batch, compute_dtype):
    """The contract of tests/test_bench_gate.py::
    test_make_chained_matches_sequential_steps: chained(n) computes the
    losses of n __call__ steps and advances training as they do; the loss
    comes back in float32."""
    x, y = batch
    _, params = _jax_params()
    net_a, step_a = _port_step(params, compute_dtype)
    net_b, step_b = _port_step(params, compute_dtype)
    for _ in range(3):
        want = step_a(x, y)
    chained = step_b.make_chained(3)
    got = chained(x, y, key=None)
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got, want.float())
    assert torch.equal(step_b.last_grad_norm, step_a.last_grad_norm)
    (va, sa), (vb, sb) = _state(net_a, step_a), _state(net_b, step_b)
    assert all(torch.equal(vb[k], v) for k, v in va.items())
    assert all(torch.equal(b, a) for a, b in zip(sa, sb))
    # repeat calls keep advancing
    chained(x, y)
    for _ in range(3):
        step_a(x, y)
    assert all(torch.equal(net_b.state_dict()[k], v)
               for k, v in net_a.state_dict().items())
    with pytest.raises(MXNetError, match="at least one step"):
        step_b.make_chained(0)


def _jax_chained(monkeypatch, x, y, n, state=None):
    """The JAX package's make_chained(n) from its initial state, or from
    ``state`` (weights with running statistics, and momentum, by name):
    the loss, then the weights with running statistics, and the momentum,
    by name; and the initial parameters."""
    import jax

    monkeypatch.setenv("MXTPU_PALLAS_CONV_DW", "1")
    monkeypatch.setenv("MXTPU_PALLAS_POOL_BWD", "1")
    net, params = _jax_params()
    by_name = net._collect_params_with_prefix()
    if state is not None:
        for k, v in state[0].items():
            by_name[k].set_data(mx.nd.array(v))
    mesh = create_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])
    jstep = JStep(net, jgl.loss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                  **HYPER)
    names = {id(p): k for k, p in by_name.items()}
    train_names = [names[id(p)] for p in jstep.trainable]
    aux_names = [names[id(p)] for p in jstep.aux]
    if state is not None:
        jstep.opt_state = tuple(
            jax.device_put(state[1][k], s.sharding)
            for k, s in zip(train_names, jstep.opt_state))
    xs, ys = jstep.put_batch(x, y)
    loss = float(np.asarray(jstep.make_chained(n)(
        xs, ys, jax.random.PRNGKey(0))))
    vals = dict(zip(train_names + aux_names,
                    (np.asarray(v) for v in jstep.train_vals
                     + jstep.aux_vals)))
    mom = dict(zip(train_names, (np.asarray(s) for s in jstep.opt_state)))
    return (loss, vals, mom), params


def _port_chained(params, x, y, n):
    net, step = _port_step(params, None)
    loss = float(step.make_chained(n)(x, y))
    names = {id(p): k for k, p in net.collect_params().items()}
    return (loss, {k: v.detach().numpy() for k, v in net.state_dict().items()},
            {names[id(p)]: s.numpy() for p, s in zip(step.trainable,
                                                     step.opt_state)})


def _assert_float32_step(got, want):
    (loss, vals, mom), (want_loss, want_vals, want_mom) = got, want
    big = max(float(np.abs(m).max()) for m in want_mom.values())
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert _worst(vals, want_vals, 1e-3) < 1e-3
    assert _worst(mom, want_mom, 1e-3 * big) < 1e-3


def test_make_chained_one_step_matches_jax(monkeypatch, batch):
    x, y = batch
    want, params = _jax_chained(monkeypatch, x, y, 1)
    _assert_float32_step(_port_chained(params, x, y, 1), want)


def test_make_chained_two_steps_match_jax(monkeypatch, batch):
    """The port's second chained step against the JAX package's step from
    the same state: the port's after one step, which its two-step chain
    passes through (test_make_chained_equals_sequential_steps)."""
    x, y = batch
    _, params = _jax_params()
    _, first_vals, first_mom = _port_chained(params, x, y, 1)
    want, _ = _jax_chained(monkeypatch, x, y, 1, (first_vals, first_mom))
    _assert_float32_step(_port_chained(params, x, y, 2), want)
