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


# -- the card's forward kernel: launch plan and rounding points ------------
#
# chip_smoke.py holds the kernel to the plain version within its TOL (abs +
# rel) and the lse within 1e-4; the emulation below is held to them
# against the JAX package's forward kernel before the card.
from tests.test_torch_attention_bwd import _mm_3xtf32  # noqa: E402

CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}
CARD_LSE_TOL = 1e-4
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}
_LOG2E = np.float32(1.4426950408889634)
_LN2 = np.float32(0.6931471805599453)
_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", _DTYPES)
def test_fwd_launch_plan_agrees_with_head_dim_buckets(dtype):
    """Every head dim the card takes gets its bucket's plan, on the route
    of its bucket and type, in a block's 227 KB of shared memory, with the
    tiles of its products: ``wgmma`` for bf16 and float16 and for float32
    up to bucket 64 (two warpgroups of 64 rows), ``mma.sync`` for float32
    at bucket 128 (four warps of 16 rows)."""
    for d in range(1, tatt.MAX_HEAD_DIM + 1):
        plan = tatt.fwd_launch_plan(d, dtype)
        assert plan.bucket == tatt.head_dim_bucket(d)
        want = ("cuda_cores" if plan.bucket == 256 else
                "tf32x3" if dtype == torch.float32 else "wgmma")
        assert plan.route == want
        assert plan.smem <= 232448
        products = ("fma" if plan.route == "cuda_cores" else "mma.sync"
                    if dtype == torch.float32 and plan.bucket == 128
                    else "wgmma")
        assert (plan.threads, plan.q_tile, plan.k_step, plan.stages) == {
            "wgmma": (256, 128, 64, 2 if dtype == torch.float32 else 4),
            "mma.sync": (128, 64, 32, 2),
            "fma": (256, 64, 64, 1)}[products]
    with pytest.raises(MXNetError):
        tatt.fwd_launch_plan(tatt.MAX_HEAD_DIM + 1, dtype)


def _kernel_rounding_fwd(q, k, v, causal, scale, step):
    """The card's forward with the kernel's rounding points: scores in
    float32 (3xTF32 for float32 inputs) scaled into log2 units, the online
    softmax over key steps of ``step`` with exp2 (the running maximum
    starting at -1e30), P rounded to the input type before P V for bf16 and
    float16 (3xTF32 with P split for float32); O in the input type, lse in
    the natural log."""
    dt = q.dtype
    qf, kf, vf = (t.float() for t in (q, k, v))
    mm = _mm_3xtf32 if dt == torch.float32 else torch.einsum
    s = mm("bhqd,bhkd->bhqk", qf, kf) * (np.float32(scale) * _LOG2E)
    sq, sk = s.shape[-2:]
    if causal:
        s = s.masked_fill(torch.arange(sk) > torch.arange(sq)[:, None],
                          -1e30)
    m = torch.full(s.shape[:-1], -1e30)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, sk, step):
        mx = torch.maximum(m, s[..., k0:k0 + step].amax(-1))
        corr = torch.exp2(m - mx)
        p = torch.exp2(s[..., k0:k0 + step] - mx.unsqueeze(-1))
        l = l * corr + p.sum(-1)
        if dt != torch.float32:
            p = p.to(dt).float()
        acc = acc * corr.unsqueeze(-1) + mm("bhqk,bhkd->bhqd", p,
                                            vf[..., k0:k0 + step, :])
        m = mx
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l.unsqueeze(-1)).to(dt), m * _LN2 + torch.log(l)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("shape", [(1, 2, 128, 128, 32, False, 64),
                                   (1, 2, 128, 128, 32, True, 64),
                                   (1, 1, 100, 100, 24, True, 20),
                                   (1, 2, 64, 128, 32, True, 64),
                                   (1, 2, 128, 64, 40, True, 32)],
                         ids=["non-causal", "causal", "ragged",
                              "Sq<Sk", "Sq>Sk"])
def test_fwd_kernel_rounding_points_match_jax_fwd_kernel(dtype, shape):
    """The rounding points of the card's forward (3xTF32 products in
    float32; exp2 over the kernel's key step; P rounded to bf16 or float16
    before P V) against _fwd_pallas in interpret mode, O within the card's
    tolerance and lse within 1e-4.  S = 100 is ragged for the card's tiles
    and key steps (Pallas runs it in blocks of 20); D = 24 and 40 fill no
    bucket."""
    b, h, sq, sk, d, causal, block = shape
    q, k, v = _inputs(b, h, sq, sk, d, seed=200 + sq + sk + d + causal)
    jq, jk, jv = (jnp.asarray(a, dtype=_JNP[dtype]) for a in (q, k, v))
    scale = 1.0 / np.sqrt(d)
    want_o, want_lse = att._fwd_pallas(jq, jk, jv, scale, causal, block,
                                       block, True)

    def port(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)

    got_o, got_lse = _kernel_rounding_fwd(
        port(jq), port(jk), port(jv), causal, scale,
        tatt.fwd_launch_plan(d, dtype).k_step)
    assert got_o.dtype == dtype
    tol = CARD_TOL[dtype]
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o, dtype=np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=CARD_LSE_TOL)


@pytest.mark.parametrize("d", [32, 96, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_forward_is_float32_accurate(d, causal):
    """The 3xTF32 route (32 keys a step) against the float32 plain version
    on the same operands, at 2e-5: its products are within 2^-20 of
    float32's, where one TF32 pass (which the card does not take) is about
    1e-3 off here."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 128, 128, d,
                                                     seed=240 + d + causal))
    want_o, want_lse = tatt.mha_reference(q, k, v, causal=causal,
                                          return_lse=True)
    got_o, got_lse = _kernel_rounding_fwd(q, k, v, causal, 1 / np.sqrt(d),
                                          32)
    torch.testing.assert_close(got_o, want_o, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_lse, want_lse, rtol=2e-5, atol=2e-5)
