"""The advanced activations, ``InstanceNorm`` and the initializers of the
PyTorch port against the JAX package.

``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``, ``Swish`` and
``InstanceNorm``: forward and input gradient (and PReLU's ``alpha``
gradient, InstanceNorm's gamma and beta) within 1e-6 of the JAX layers on
the same seeded input.  ``Bilinear``, ``Mixed`` and ``Load`` fill
bitwise as the JAX initializers do.  ``Orthogonal`` and ``MSRAPrelu``
draw from numpy generators the JAX package's key-based ones cannot
match, so they are held to their laws: orthonormal rows (or columns)
times ``scale``; a gaussian of deviation ``sqrt(2 / (1 + slope^2) /
fan)``.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-6


def _layers(mx):
    nn = mx.gluon.nn
    return [("LeakyReLU", lambda: nn.LeakyReLU(0.1), (3, 4, 5)),
            ("PReLU", lambda: nn.PReLU(mx.init.Constant(0.3)), (3, 4, 5)),
            ("ELU", lambda: nn.ELU(0.7), (3, 4, 5)),
            ("SELU", nn.SELU, (3, 4, 5)),
            ("GELU", nn.GELU, (3, 4, 5)),
            ("Swish", lambda: nn.Swish(1.5), (3, 4, 5)),
            ("InstanceNorm", lambda: nn.InstanceNorm(in_channels=4,
                                                     scale=True),
             (2, 4, 3, 5))]


def _run(mx, make, x):
    """Output, input gradient and parameter gradients of ``sum(out * c)``,
    ``c`` seeded (a loss whose every gradient is away from 0)."""
    layer = make()
    layer.initialize()
    data = mx.nd.array(x, ctx=mx.cpu())
    c = mx.nd.array(np.random.RandomState(9).rand(*x.shape).astype(
        np.float32), ctx=mx.cpu())
    data.attach_grad()
    with mx.autograd.record():
        out = layer(data)
        loss = (out * c).sum()
    loss.backward()
    grads = {k.split("_")[-1]: p.grad().asnumpy()
             for k, p in layer.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), data.grad.asnumpy(), grads


@pytest.mark.parametrize("index", range(7),
                         ids=[n for n, _, _ in _layers(tmx)])
def test_activations_and_instance_norm_match_jax(index):
    name, tmake, shape = _layers(tmx)[index]
    _, jmake, _ = _layers(jmx)[index]
    x = np.random.RandomState(index).randn(*shape).astype(np.float32)
    with tmx.cpu():
        got = _run(tmx, tmake, x)
    want = _run(jmx, jmake, x)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL,
                               err_msg=name)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL,
                               err_msg=name)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=TOL,
                                   atol=TOL, err_msg=name + " " + k)


def _fill(init, name, shape, mx):
    if mx is jmx:
        arr = np.zeros(shape, np.float32)
        init(jmx.init.InitDesc(name), arr)
        return arr
    arr = np.zeros(shape, np.float32)
    init(tmx.init.InitDesc(name), arr, np.random.RandomState(0))
    return arr


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 5, 7), (3, 2, 6, 3)])
def test_bilinear_is_bitwise(shape):
    got = _fill(tmx.init.Bilinear(), "up_weight", shape, tmx)
    want = _fill(jmx.init.Bilinear(), "up_weight", shape, jmx)
    assert np.array_equal(got, want)


def test_mixed_and_load_are_bitwise():
    params = {"arg:fc_weight": np.arange(6, dtype=np.float32).reshape(2, 3),
              "aux:bn_running_mean": np.full((3,), 0.25, np.float32)}
    for mx in (tmx, jmx):
        mixed = mx.init.Mixed([".*bias", ".*gamma", ".*"],
                              [mx.init.Constant(0.5), mx.init.One(),
                               mx.init.Zero()])
        load = mx.init.Load(params, default_init=mx.init.Constant(2.0))
        got = [_fill(mixed, n, (3,), mx) for n in ("a_bias", "b_gamma",
                                                    "c_weight")]
        got += [_fill(load, "fc_weight", (2, 3), mx),
                _fill(load, "bn_running_mean", (3,), mx),
                _fill(load, "other_weight", (2,), mx)]
        if mx is tmx:
            port = got
    for a, b in zip(port, got):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="did not match"):
        _fill(tmx.init.Mixed(["x.*"], [tmx.init.One()]), "y_weight", (2,),
              tmx)
    with pytest.raises(ValueError, match="shape mismatch"):
        _fill(tmx.init.Load(params), "fc_weight", (3, 2), tmx)


def test_mixed_drives_a_block_initialize():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=2)
    net.initialize(tmx.init.Mixed([".*bias", ".*"],
                                  [tmx.init.Constant(0.5),
                                   tmx.init.Constant(2.0)]))
    # the bias's own initializer ("zeros") wins, as in the reference
    assert (net.bias.data().asnumpy() == 0).all()
    assert (net.weight.data().asnumpy() == 2.0).all()


@pytest.mark.parametrize("shape,rand_type", [((4, 6), "uniform"),
                                             ((6, 4), "normal"),
                                             ((3, 2, 3, 3), "uniform")])
def test_orthogonal_law(shape, rand_type):
    init = tmx.init.Orthogonal(scale=1.5, rand_type=rand_type)
    w = _fill(init, "w_weight", shape, tmx).reshape(shape[0], -1)
    if w.shape[0] <= w.shape[1]:
        gram = w @ w.T
    else:
        gram = w.T @ w
    np.testing.assert_allclose(gram, 1.5 ** 2 * np.eye(len(gram)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("factor_type", ["in", "out", "avg"])
def test_msra_prelu_law(factor_type):
    slope = 0.3
    shape = (64, 32, 3, 3)
    w = _fill(tmx.init.MSRAPrelu(factor_type, slope), "c_weight", shape,
              tmx)
    fan_in, fan_out = 32 * 9, 64 * 9
    fan = {"in": fan_in, "out": fan_out,
           "avg": (fan_in + fan_out) / 2.0}[factor_type]
    std = np.sqrt(2.0 / (1 + slope ** 2) / fan)
    assert abs(w.mean()) < 3 * std / np.sqrt(w.size)
    assert abs(w.std() / std - 1) < 0.02
    assert "msraprelu" in tmx.init.MSRAPrelu().dumps()


def test_initializers_are_registered_under_both_names():
    assert tmx.init is tmx.initializer
    for name in ("orthogonal", "msraprelu", "bilinear"):
        assert isinstance(tmx.init.create(name), tmx.init.Initializer)
