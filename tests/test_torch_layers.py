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
    with pytest.raises(ValueError):
        tgnn.Dense(4, device="cpu")  # no deferred input width in the port


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
