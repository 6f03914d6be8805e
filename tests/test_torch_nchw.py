"""The registered Convolution and Pooling of the port in the JAX ops'
default layout (``layout=None`` or ``"NCHW"``: NCHW data, OIHW weights),
held against the JAX ops on the CPU: the forward and every input's
gradient for one cotangent, within 1e-5 of the JAX result's largest
magnitude.  The port runs them through its NHWC path, so the weight
gradient is conv_dw's and the max-pool input gradient maxpool_bwd's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import conv_dw, pool_bwd
from mxnet_tpu_torch.ops import registry as treg

TOL = 1e-5


def _both(name, arrays, attrs, seed=1):
    """(port outputs and input gradients, JAX's) for one cotangent."""
    jop = jreg.get(name)
    jattrs = jop.canonicalize_attrs(attrs)
    jargs = [jnp.asarray(a) for a in arrays]
    jout, vjp = jax.vjp(lambda *xs: jop.fn(*xs, **jattrs), *jargs)
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    tout = treg.apply_op(name, *ts, **attrs)
    tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(cot))
    return ([tout.detach().numpy()] + [g.numpy() for g in tgrads],
            [np.asarray(jout)] + [np.asarray(g) for g in jgrads])


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale)


CONV_CASES = [
    # (name, data shape, weight shape, attrs)
    ("1ch", (2, 1, 12, 12), (4, 1, 5, 5), {"kernel": (5, 5),
                                           "num_filter": 4}),
    ("2ch-stride-pad", (2, 2, 9, 9), (3, 2, 3, 3),
     {"kernel": (3, 3), "num_filter": 3, "stride": (2, 2), "pad": (1, 1)}),
    ("2ch-no-bias", (3, 2, 8, 7), (5, 2, 3, 2),
     {"kernel": (3, 2), "num_filter": 5, "stride": (1, 2), "no_bias": True}),
    ("lenet-conv2", (2, 4, 12, 12), (8, 4, 5, 5),
     {"kernel": (5, 5), "num_filter": 8}),
]


@pytest.mark.parametrize("layout", [None, "NCHW"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_convolution_nchw_matches_jax(case, layout):
    _, xs, ws, attrs = case
    rng = np.random.RandomState(3)
    arrays = [rng.randn(*xs).astype(np.float32),
              rng.randn(*ws).astype(np.float32)]
    if not attrs.get("no_bias"):
        arrays.append(rng.randn(ws[0]).astype(np.float32))
    attrs = dict(attrs, layout=layout) if layout else dict(attrs)
    got, want = _both("Convolution", arrays, attrs)
    _close(got, want)


POOL_CASES = [
    ("max-2x2-s2", (2, 3, 8, 8), {"kernel": (2, 2), "stride": (2, 2),
                                  "pool_type": "max"}),
    ("max-3x3-s2-p1", (2, 2, 9, 9), {"kernel": (3, 3), "stride": (2, 2),
                                     "pad": (1, 1), "pool_type": "max"}),
    ("max-full", (2, 3, 7, 7), {"kernel": (2, 2), "stride": (2, 2),
                                "pool_type": "max",
                                "pooling_convention": "full"}),
    ("avg-valid", (2, 3, 7, 7), {"kernel": (3, 3), "stride": (2, 2),
                                 "pool_type": "avg"}),
    ("avg-full-pad", (2, 3, 7, 7), {"kernel": (3, 3), "stride": (2, 2),
                                    "pad": (1, 1), "pool_type": "avg",
                                    "pooling_convention": "full"}),
    ("sum", (2, 2, 6, 6), {"kernel": (2, 3), "stride": (1, 1),
                           "pool_type": "sum"}),
    ("global-max", (2, 3, 5, 6), {"global_pool": True, "pool_type": "max",
                                  "kernel": (1, 1)}),
    ("global-avg", (2, 3, 5, 6), {"global_pool": True, "pool_type": "avg",
                                  "kernel": (1, 1)}),
]


@pytest.mark.parametrize("layout", [None, "NCHW"])
@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_pooling_nchw_matches_jax(case, layout):
    _, xs, attrs = case
    x = np.random.RandomState(5).randn(*xs).astype(np.float32)
    attrs = dict(attrs, layout=layout) if layout else dict(attrs)
    got, want = _both("Pooling", [x], attrs)
    _close(got, want)


def test_nchw_routes_through_the_kernel_wrappers(monkeypatch):
    """The NCHW ops' weight gradient is conv_dw's and the max pool's input
    gradient maxpool_bwd's, called on the NHWC views."""
    seen = []
    real_dw, real_pool = conv_dw.conv_dw, pool_bwd.maxpool_bwd

    def dw(x, dy, *a, **k):
        seen.append(("dw", tuple(x.shape), tuple(dy.shape)))
        return real_dw(x, dy, *a, **k)

    def pool(x, dy, *a, **k):
        seen.append(("pool", tuple(x.shape)))
        return real_pool(x, dy, *a, **k)

    from mxnet_tpu_torch.ops import nn as tnn

    monkeypatch.setattr(tnn, "conv_dw", dw)
    monkeypatch.setattr(tnn, "maxpool_bwd", pool)
    x = torch.randn(2, 1, 12, 12, requires_grad=True)
    w = torch.randn(4, 1, 5, 5, requires_grad=True)
    y = treg.apply_op("Convolution", x, w, kernel=(5, 5), num_filter=4,
                      no_bias=True)
    y = treg.apply_op("Pooling", y, kernel=(2, 2), stride=(2, 2))
    y.sum().backward()
    assert seen == [("pool", (2, 8, 8, 4)),
                    ("dw", (2, 12, 12, 1), (2, 8, 8, 4))]


def test_nd_convolution_default_layout_runs():
    """``mx.nd.Convolution(x, w, kernel=(5, 5), num_filter=20)`` runs in
    the port as in the JAX package."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 1, 28, 28).astype(np.float32)
    w = rng.randn(20, 1, 5, 5).astype(np.float32)
    b = np.zeros(20, np.float32)
    got = tnd.Convolution(tnd.array(x, ctx="cpu"), tnd.array(w, ctx="cpu"),
                          tnd.array(b, ctx="cpu"), kernel=(5, 5),
                          num_filter=20)
    want = jreg.get("Convolution").fn(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), kernel=(5, 5),
                                      num_filter=20)
    assert got.shape == (2, 20, 24, 24)
    _close([got.asnumpy()], [np.asarray(want)])


def test_nchw_takes_2d_data_only():
    """1-D and 3-D data run now (tests/test_torch_conv_nd.py); data of
    four spatial dimensions, and weights of another rank, raise."""
    with pytest.raises(MXNetError, match="1-D, 2-D or 3-D"):
        treg.apply_op("Convolution", torch.zeros(2, 3, 4, 4, 4, 4),
                      torch.zeros(4, 3, 3, 3, 3, 3), num_filter=4)
    with pytest.raises(MXNetError, match="1-D, 2-D or 3-D"):
        treg.apply_op("Pooling", torch.zeros(2, 3, 4, 4, 4, 4),
                      kernel=(2, 2, 2, 2))
    with pytest.raises(MXNetError, match="NCW data and OIW weights"):
        treg.apply_op("Convolution", torch.zeros(2, 3, 8),
                      torch.zeros(4, 3, 3, 3), kernel=(3,), num_filter=4)
