"""The port's attention (mxnet_tpu_torch/ops/attention.py) against the JAX
package's flash attention, run as tests/test_attention.py runs it on the
CPU: the Pallas kernel in interpret mode, or its fallback for ragged
sequences.  On CPU tensors the port's wrapper takes its plain version, so
these tests hold the plain version's arithmetic; chip_smoke.py holds the
CUDA kernel against it on the card.

Tolerance: rtol = atol = 2e-4 in float32, as tests/test_attention.py
holds the Pallas kernel against its reference (the sums run in another
order in each package); 2e-2 for bfloat16 and float16, as the bf16 test
below (the probabilities are rounded to the input type before the second
product in both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as att
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tatt

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    return tatt.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                **kw)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blocks", [64, 128])
def test_flash_matches_jax_kernel(causal, blocks):
    q, k, v = _inputs(1, 2, 128, 128, 32, seed=blocks + causal)
    want = att.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, interpret=True,
                               block_q=blocks, block_k=blocks)
    got = _port(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax_reference(causal):
    q, k, v = _inputs(2, 2, 64, 64, 16, seed=5)
    want = att.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    got = tatt.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_rectangular_kv(causal):
    """Sq != Sk; the causal mask stays top-left aligned (col > row)."""
    q, _, _ = _inputs(1, 2, 64, 64, 32, seed=7)
    _, k, v = _inputs(1, 2, 128, 128, 32, seed=8)
    want = att.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, interpret=True,
                               block_q=64, block_k=64)
    got = _port(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_sequence(causal):
    """S=100 divides no block: the JAX package falls back to its
    reference; the port (and its kernel) masks the ragged edge itself."""
    q, k, v = _inputs(1, 2, 100, 100, 16, seed=9)
    want = att.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, interpret=True,
                               block_q=64, block_k=64)
    got = _port(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax_kernel(causal):
    q, k, v = _inputs(1, 2, 128, 128, 32, seed=11)
    want_o, want_lse = att._fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0 / np.sqrt(32),
        causal, 64, 64, True)
    got_o, got_lse = _port(q, k, v, causal=causal, return_lse=True)
    assert got_lse.shape == (1, 2, 128) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_sm_scale_passes_through():
    q, k, v = _inputs(1, 1, 64, 64, 16, seed=12)
    want = att.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               sm_scale=0.3, interpret=True,
                               block_q=64, block_k=64)
    got = _port(q, k, v, sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_plain_version_matches_jax_reference():
    """bfloat16 in, scores in float32, probabilities cast to bf16 before
    the second product, bf16 out — as the JAX reference does.  Held at
    2e-2, bf16's rounding step near 1."""
    q, k, v = _inputs(1, 2, 64, 64, 32, seed=13)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(att.mha_reference(jq, jk, jv, causal=True)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tatt.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed_dtype",
                                 "noncontig", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 32, 32, 16, 14))
    if bad == "head_dim":  # q's head dim differs from k's and v's
        k, v = (t[..., :8].contiguous() for t in (k, v))
    elif bad == "dtype":
        q, k, v = (t.double() for t in (q, k, v))
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "noncontig":
        q = q.transpose(2, 3)
        k = k.transpose(2, 3)
        v = v.transpose(2, 3)
    else:
        k = k[:, :1].contiguous()
    with pytest.raises(MXNetError):
        tatt.flash_attention(q, k, v)


def test_cpu_path_launches_no_kernel():
    before = tatt.flash_attention.launches
    _port(*_inputs(1, 1, 32, 32, 16, 15), causal=True)
    assert tatt.flash_attention.launches == before == 0


HEAD_DIMS = (8, 24, 96, 160, 256)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_any_head_dim_matches_jax_kernel(d):
    """Head dims off the card's buckets (8, 24, 96, 160) and the largest
    bucket (256): the plain version takes any D, as the Pallas kernel does
    in interpret mode."""
    q, k, v = _inputs(1, 2, 128, 128, d, seed=20 + d)
    want = att.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, interpret=True, block_q=64,
                               block_k=64)
    got, lse = _port(q, k, v, causal=True, return_lse=True)
    assert got.shape == (1, 2, 128, d) and lse.shape == (1, 2, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_head_dim_buckets_of_the_card():
    """The kernels' bucket for each head dim, and the limit that raises on
    the card (checked there by chip_smoke.py phase 3)."""
    assert [tatt.head_dim_bucket(d) for d in (1, 8, 32, 33, 64, 96, 128,
                                              129, 160, 256)] \
        == [32, 32, 32, 64, 64, 128, 128, 256, 256, 256]
    assert tatt.MAX_HEAD_DIM == 256
    for d in (0, 257, 264):
        with pytest.raises(MXNetError, match="head_dim 1 to 256"):
            tatt.head_dim_bucket(d)


@pytest.mark.parametrize("causal", [False, True])
def test_float16_plain_version_matches_jax_kernel(causal):
    """float16 in: scores and softmax in float32, probabilities cast to
    float16 before the second product, float16 out."""
    q, k, v = _inputs(1, 2, 128, 128, 32, seed=16)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.float16) for a in (q, k, v))
    want = np.asarray(att.flash_attention(
        jq, jk, jv, causal=causal, interpret=True, block_q=64,
        block_k=64).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).half() for a in (q, k, v))
    got = tatt.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
