"""The port's ops and layers (mxnet_tpu_torch/ops, gluon/nn/basic_layers.py)
against the JAX package's ops on the same numpy inputs, on the CPU.

Tolerance 1e-5 (rtol and atol): one float32 op each, computed in another
order by each package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import contrib as jcontrib
from mxnet_tpu.ops import matrix as jmatrix
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.ops import matrix as tmatrix
from mxnet_tpu_torch.ops import nn as tnn

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("flatten,no_bias", [(True, False), (False, False),
                                             (False, True)])
def test_fully_connected(flatten, no_bias):
    x, b = _rand(3, 4, 5, seed=1), _rand(6, seed=3)
    w = _rand(6, 20 if flatten else 5, seed=2)
    want = jnn.fully_connected(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               num_hidden=6, no_bias=no_bias, flatten=flatten)
    got = tnn.fully_connected(_t(x), _t(w), None if no_bias else _t(b),
                              flatten=flatten)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_is_exact_erf_form():
    x = _rand(4, 33, seed=4) * 3
    want = jnn.leaky_relu(jnp.asarray(x), act_type="gelu")
    got = tnn.leaky_relu(_t(x), act_type="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm(axis):
    x = _rand(2, 8, 16, seed=6) * 4 + 1
    c = x.shape[axis]
    g, b = _rand(c, seed=7), _rand(c, seed=8)
    want = jnn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          axis=axis, eps=1e-5)
    got = tnn.layer_norm(_t(x), _t(g), _t(b), axis=axis, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dropout_is_identity_at_inference():
    x = _rand(4, 8, seed=9)
    layer = tgnn.Dropout(0.5, device="cpu")
    np.testing.assert_array_equal(layer(_t(x)).numpy(), x)


@pytest.mark.parametrize("ids", [
    [[0, 3, 96], [5, 5, 1]],             # in range
    [[-1, -97, 2], [-50, 0, 96]],         # wrap: -1 -> 96, -97 -> 0
    [[97, 3, -98], [1000, 2, 7]],         # out of range -> NaN rows
    [[2.7, -0.5, 95.9], [3.0, 1.2, -1.5]],  # float ids truncate toward 0
])
def test_embedding_index_semantics(ids):
    ids = np.asarray(ids, dtype=np.float32)
    w = _rand(97, 8, seed=10)
    want = np.asarray(jmatrix.embedding(jnp.asarray(ids), jnp.asarray(w)))
    got = tmatrix.embedding(_t(ids), _t(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)  # NaN rows compare equal
    assert np.isnan(want).any() == np.isnan(got).any()


def test_embedding_integer_ids_and_nonfinite():
    w = _rand(11, 4, seed=11)
    ids = torch.tensor([[0, -11, 10, 11, -12]])
    got = tmatrix.embedding(ids, _t(w))
    np.testing.assert_array_equal(got[0, :3].numpy(), w[[0, 0, 10]])
    assert torch.isnan(got[0, 3:]).all()
    # the port maps NaN / inf ids to a NaN row (the JAX cast maps NaN to
    # id 0); either way no out-of-range index reaches the gather
    bad = tmatrix.embedding(torch.tensor([float("nan"), float("inf")]),
                            _t(w))
    assert torch.isnan(bad).all()


def test_shape_ops_match_jax():
    x = _rand(2, 3, 12, seed=12)
    np.testing.assert_array_equal(
        tmatrix.reshape(_t(x), (0, 0, 4, 3)).numpy(),
        np.asarray(jmatrix.reshape(jnp.asarray(x), shape=(0, 0, 4, 3))))
    np.testing.assert_array_equal(
        tmatrix.transpose(_t(x), (0, 2, 1)).numpy(),
        np.asarray(jmatrix.transpose(jnp.asarray(x), axes=(0, 2, 1))))
    np.testing.assert_array_equal(
        tmatrix.slice_axis(_t(x), 2, 4, 9).numpy(),
        np.asarray(jmatrix.slice_axis(jnp.asarray(x), axis=2, begin=4,
                                      end=9)))
    np.testing.assert_array_equal(
        tmatrix.arange_like(_t(x[:1, 0]), axis=1).numpy(),
        np.asarray(jcontrib.arange_like(jnp.asarray(x[:1, 0]), axis=1)))


def test_layers_hold_jax_names_and_layouts():
    dense = tgnn.Dense(6, in_units=5, device="cpu")
    assert {k: tuple(v.shape) for k, v in dense.collect_params().items()} \
        == {"weight": (6, 5), "bias": (6,)}
    ln = tgnn.LayerNorm(in_channels=7, device="cpu").initialize()
    np.testing.assert_array_equal(ln.gamma.detach().numpy(), np.ones(7))
    np.testing.assert_array_equal(ln.beta.detach().numpy(), np.zeros(7))
    emb = tgnn.Embedding(10, 3, device="cpu").initialize(seed=3)
    w = emb.weight.detach().numpy()
    assert np.abs(w).max() <= 0.07 and np.abs(w).max() > 0  # Uniform(0.07)
    lazy = tgnn.Dense(4, device="cpu")  # the width comes at the first call
    out = lazy(torch.ones(2, 3, 5))  # flattened: 3 * 5 inputs
    assert tuple(lazy.weight.shape) == (4, 15)
    assert tuple(out.shape) == (2, 4)


@pytest.mark.parametrize("fmt", ["dict", "list"])
def test_ndarray_files_cross_packages(fmt, tmp_path):
    """mx.nd.save files load into the port and the port's files load
    into mx.nd.load, in both the dict and the list layout."""
    import mxnet_tpu as mx
    from mxnet_tpu_torch import ndarray as tnd

    a, b = _rand(3, 4, seed=13), _rand(5, seed=14)
    data = {"w": a, "b": b} if fmt == "dict" else [a, b]
    jpath, tpath = str(tmp_path / "j.nd"), str(tmp_path / "t.nd")
    mx.nd.save(jpath, {k: mx.nd.array(v) for k, v in data.items()}
               if fmt == "dict" else [mx.nd.array(v) for v in data])
    tnd.save(tpath, {k: _t(v) for k, v in data.items()} if fmt == "dict"
             else [_t(v) for v in data])
    got_t = tnd.load(jpath, ctx="cpu")
    got_j = mx.nd.load(tpath)
    if fmt == "dict":
        for k, v in data.items():
            np.testing.assert_array_equal(got_t[k].asnumpy(), v)
            np.testing.assert_array_equal(got_j[k].asnumpy(), v)
    else:
        for i, v in enumerate(data):
            np.testing.assert_array_equal(got_t[i].asnumpy(), v)
            np.testing.assert_array_equal(got_j[i].asnumpy(), v)


def _jax_layer(cls, args, kwargs, x):
    """A JAX package layer built with ``args`` and ``kwargs``, initialised
    and run once on ``x`` (its parameters by structural name, its
    output)."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import nn as jgnn

    mx.random.seed(21)
    layer = getattr(jgnn, cls)(*args, **kwargs)
    layer.initialize()
    out = layer(mx.nd.array(x)).asnumpy()
    return {k: p.data().asnumpy()
            for k, p in layer._collect_params_with_prefix().items()}, out


# the same positional arguments in both packages: (layer, positional
# arguments, keywords, input shape)
POSITIONAL = [
    ("Dense", (4, "relu"), {"in_units": 3}, (5, 3)),
    ("Dense", (4, "tanh", False), {"in_units": 6}, (5, 6)),
    ("Dense", (4, None, True, False), {"in_units": 6}, (2, 5, 6)),
    ("Dense", (4, "sigmoid", True, True, "float32", None, "zeros", 6), {},
     (2, 3, 2)),
    ("LayerNorm", (1, 1e-3, True, True, "zeros", "ones", 8), {}, (2, 8, 5)),
    ("LayerNorm", (-1, 1e-5, False, False), {"in_channels": 7}, (3, 7)),
    ("Embedding", (10, 3, "float32", None), {}, (2, 4)),
    ("Conv2D", (6, 3, 1, 1, 1, 1, "NHWC", "relu", True, None, "zeros", 5), {},
     (2, 7, 7, 5)),
    ("BatchNorm", (3, 0.9, 1e-5, True, True, False, "zeros", "ones", "zeros",
                   "ones", 4), {}, (2, 5, 5, 4)),
]


@pytest.mark.parametrize("cls,args,kwargs,shape", POSITIONAL,
                         ids=[c[0] + str(i) for i, c in enumerate(POSITIONAL)])
def test_positional_arguments_build_the_jax_layer(cls, args, kwargs, shape):
    """Each port layer takes the JAX package's positional order
    (``device`` last, a keyword only): the same arguments build the same
    layer, whose output matches within 1e-6 with the JAX weights."""
    from mxnet_tpu_torch.convert import load_mxnet_tpu_params

    rs = np.random.RandomState(22)
    x = (rs.randint(0, 10, size=shape).astype(np.float32) if cls ==
         "Embedding" else rs.normal(size=shape).astype(np.float32))
    params, want = _jax_layer(cls, args, kwargs, x)
    layer = load_mxnet_tpu_params(
        getattr(tgnn, cls)(*args, device="cpu", **kwargs), params)
    with torch.inference_mode():
        got = layer(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if args[1:2] == ("relu",):  # Dense(4, 'relu'): the activation applies
        assert got.min() >= 0 and want.min() >= 0 and (got == 0).any()


def test_dropout_takes_axes_second():
    """Dropout(rate, axes): the mask is shared along ``axes`` in train
    mode; at inference both packages pass the input through."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import nn as jgnn
    from mxnet_tpu_torch import autograd as tautograd

    x = np.ones((4, 6, 5), np.float32)
    jl, tl = jgnn.Dropout(0.5, (1,)), tgnn.Dropout(0.5, (1,), device="cpu")
    np.testing.assert_array_equal(tl(_t(x)).numpy(),
                                  jl(mx.nd.array(x)).asnumpy())
    with tautograd.record():
        y = tl(_t(x)).numpy()
    assert set(np.unique(y)) <= {0.0, 2.0}
    assert (y == y[:, :1]).all()  # one mask for every index along axis 1


def test_layer_initializers_fill_as_jax():
    """A layer's own initializers fill its parameters whatever the name,
    as in the JAX package."""
    from mxnet_tpu.gluon import nn as jgnn

    jd = jgnn.Dense(3, None, True, True, "float32", "ones", "ones", 2)
    jd.initialize()
    td = tgnn.Dense(3, None, True, True, "float32", "ones", "ones", 2,
                    device="cpu").initialize(seed=1)
    for name in ("weight", "bias"):
        np.testing.assert_array_equal(getattr(td, name).detach().numpy(),
                                      getattr(jd, name).data().asnumpy())
    ln = tgnn.LayerNorm(-1, 1e-5, True, True, "ones", "zeros",
                        4, device="cpu").initialize()
    assert ln.beta.detach().tolist() == [1.0] * 4
    assert ln.gamma.detach().tolist() == [0.0] * 4


def test_layer_arguments_the_port_does_not_take_raise():
    from mxnet_tpu_torch.base import MXNetError

    with pytest.raises(TypeError):  # device is a keyword only
        tgnn.Dense(3, None, True, True, "float32", None, "zeros", 2, "cpu")
    with pytest.raises(MXNetError, match="sparse_grad"):
        tgnn.Embedding(10, 3, "float32", None, True, device="cpu")
    with pytest.raises(ValueError, match="unknown initializer"):
        tgnn.Dense(3, in_units=2, weight_initializer="orthogonal",
                   device="cpu").initialize()
