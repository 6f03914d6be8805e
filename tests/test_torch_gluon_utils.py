"""The port's gluon.utils against the JAX package's, on the CPU.

``clip_global_norm``: under the norm (the arrays untouched), over it (the
arrays rescaled), and with a NaN (a warning, the arrays untouched); the
returned norm within 1e-6 relative and the arrays within 1e-6 (float32
sums in another order).  ``split_data`` and ``split_and_load``: the
slices equal the JAX package's exactly, even and uneven, and an uneven
even split raises in both.  ``check_sha1`` on a file.
"""

import hashlib
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import utils as jutils
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon import utils as tutils

SHAPES = [(3, 4), (5,), (2, 3, 2)]


def _arrays(seed, nan=False):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    if nan:
        arrays[1][2] = np.nan
    return arrays


@pytest.mark.parametrize("case,max_norm", [("under", 100.0), ("over", 1.5),
                                           ("nan", 1.5)])
def test_clip_global_norm_matches_jax(case, max_norm):
    arrays = _arrays(4, nan=case == "nan")
    nds = [mx.nd.array(a) for a in arrays]
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jutils.clip_global_norm(nds, max_norm)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tutils.clip_global_norm(ts, max_norm)
    assert isinstance(got, float)
    assert len(tw) == len(jw) == (1 if case == "nan" else 0)
    if case == "nan":
        assert np.isnan(got) and np.isnan(want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert (got > max_norm) == (case == "over")
    for t, nd, a in zip(ts, nds, arrays):
        np.testing.assert_allclose(t.numpy(), nd.asnumpy(), rtol=1e-6,
                                   atol=1e-6)
        if case != "over":  # left as they were
            np.testing.assert_array_equal(t.numpy(), a)
    if case == "over":
        total = np.sqrt(sum(float((t.double() ** 2).sum()) for t in ts))
        np.testing.assert_allclose(total, max_norm, rtol=1e-5)


@pytest.mark.parametrize("size,slices,even", [(8, 4, True), (10, 3, False),
                                              (2, 4, False)])
@pytest.mark.parametrize("axis", [0, 1])
def test_split_and_load_matches_jax(size, slices, even, axis):
    shape = (size, 3) if axis == 0 else (3, size)
    data = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    want = jutils.split_and_load(data, [mx.cpu()] * slices, axis, even)
    got = gluon.split_and_load(data, ["cpu"] * slices, axis, even)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w.asnumpy())
    parts = tutils.split_data(torch.from_numpy(data), slices, axis, even)
    np.testing.assert_array_equal(torch.cat(parts, axis).numpy(), data)


def test_uneven_split_raises_and_check_sha1(tmp_path):
    with pytest.raises(ValueError):
        jutils.split_data(mx.nd.zeros((10, 2)), 3)
    with pytest.raises(ValueError):
        tutils.split_data(torch.zeros(10, 2), 3)
    one = gluon.split_and_load(torch.ones(4, 2), ["cpu"])
    assert len(one) == 1 and torch.equal(one[0], torch.ones(4, 2))
    path = tmp_path / "blob"
    path.write_bytes(b"word language model" * 1000)
    sha = hashlib.sha1(path.read_bytes()).hexdigest()
    assert tutils.check_sha1(str(path), sha) == jutils.check_sha1(str(path),
                                                                  sha)
    assert tutils.check_sha1(str(path), sha)
    assert not tutils.check_sha1(str(path), "0" * 40)
