"""The backward of the port's attention (mxnet_tpu_torch/ops/attention.py)
against the JAX package's, run as tests/test_attention.py runs it on the
CPU: the Pallas backward kernels in interpret mode, or ``jax.grad`` of the
reference for shapes the JAX package sends to its fallback.  On CPU tensors
the port's wrappers take their plain versions, so these tests hold the
plain versions' arithmetic and the autograd wiring that the card shares;
chip_smoke.py holds the CUDA kernels against the plain versions on the card.

Tolerances: 2e-4 where the same q, k, v, o, lse and dO go through both
backward functions (float32 sums in another order); 2e-3 for gradients
through the whole forward and backward, as tests/test_attention.py holds
the Pallas kernels against ``jax.grad`` of the reference; 2e-2 for
bfloat16 and float16 gradients, which are rounded to the input type in
both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as att
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tatt

BWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _qkv(b, h, sq, sk, d, seed):
    return _arrays([(b, h, sq, d), (b, h, sk, d), (b, h, sk, d)], seed)


def _jax_grads(fn, q, k, v):
    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o * jnp.cos(o))

    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))


def _port_grads(q, k, v, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tatt.flash_attention(*ts, **kw)
    return torch.autograd.grad((o * torch.cos(o)).sum(), ts)


def _assert_all_close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, dtype=np.float32), **tol)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_jax_bwd_kernels(causal):
    """The same q, k, v, o, lse and dO through _bwd_pallas (interpret
    mode, blocks 64) and the port's plain backward."""
    q, k, v, do = _arrays([(1, 2, 128, 32)] * 4, seed=20 + causal)
    scale = 1.0 / np.sqrt(32)
    o, lse = att._fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale, causal, 64, 64, True)
    want = att._bwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o,
                           lse, jnp.asarray(do), scale, causal, 64, 64, True)
    got = tatt.flash_attention_bwd_reference(
        *(torch.from_numpy(np.asarray(a)) for a in (q, k, v, o, lse, do)),
        causal=causal)
    _assert_all_close(got, want, BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_flash_kernels(causal):
    q, k, v = _qkv(1, 2, 128, 128, 32, seed=30 + causal)
    want = _jax_grads(lambda q, k, v: att.flash_attention(
        q, k, v, causal=causal, interpret=True, block_q=64, block_k=64),
        q, k, v)
    _assert_all_close(_port_grads(q, k, v, causal=causal), want, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_rectangular_kv(causal):
    """Sq != Sk, both ways; the causal mask stays top-left aligned."""
    for sq, sk in ((64, 128), (128, 64)):
        q, k, v = _qkv(1, 2, sq, sk, 32, seed=40 + sq)
        want = _jax_grads(lambda q, k, v: att.flash_attention(
            q, k, v, causal=causal, interpret=True, block_q=64, block_k=64),
            q, k, v)
        _assert_all_close(_port_grads(q, k, v, causal=causal), want,
                          GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_ragged_sequence(causal):
    """S=100 divides no block: the JAX package differentiates its
    reference; the port's Function (and its kernels) mask the edge."""
    q, k, v = _qkv(1, 2, 100, 100, 16, seed=50)
    want = _jax_grads(lambda q, k, v: att.mha_reference(q, k, v,
                                                        causal=causal),
                      q, k, v)
    _assert_all_close(_port_grads(q, k, v, causal=causal), want, GRAD_TOL)


def test_grads_sm_scale():
    q, k, v = _qkv(1, 1, 64, 64, 16, seed=60)
    want = _jax_grads(lambda q, k, v: att.flash_attention(
        q, k, v, sm_scale=0.3, interpret=True, block_q=64, block_k=64),
        q, k, v)
    _assert_all_close(_port_grads(q, k, v, sm_scale=0.3), want, GRAD_TOL)


def test_bf16_bwd_reference_matches_jax_bwd_kernels():
    """bfloat16 q, k, v, o and dO; every product in float32 and each
    gradient rounded to bfloat16 in both.  Held at 2e-2: a float32 sum in
    another order may round to the neighbouring bfloat16 value, a step of
    2**-8 relative (about 1.6e-2 at a magnitude of 4)."""
    q, k, v, do = _arrays([(1, 2, 128, 32)] * 4, seed=70)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype=jnp.bfloat16)
                       for a in (q, k, v, do))
    scale = 1.0 / np.sqrt(32)
    o, lse = att._fwd_pallas(jq, jk, jv, scale, True, 64, 64, True)
    want = att._bwd_pallas(jq, jk, jv, o, lse, jdo, scale, True, 64, 64,
                           True)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
            torch.bfloat16)

    got = tatt.flash_attention_bwd_reference(
        bf16(jq), bf16(jk), bf16(jv), bf16(o),
        torch.from_numpy(np.asarray(lse)), bf16(jdo), causal=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_all_close(got, [np.asarray(w, dtype=np.float32) for w in want],
                      dict(rtol=2e-2, atol=2e-2))


def test_function_node_on_cpu_and_no_launches():
    """The CPU runs the same autograd Function as the card; no kernel
    launch is counted on the CPU."""
    def counts():
        return (tatt.flash_attention.launches,
                tatt.flash_attention_bwd_dq.launches,
                tatt.flash_attention_bwd_dkv.launches)

    before = counts()
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 2, 64, 64, 16, seed=80))
    o = tatt.flash_attention(q, k, v, causal=True)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert counts() == before == (0, 0, 0)


def test_inference_mode_saves_nothing():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 1, 32, 32, 16, seed=81))
    with torch.inference_mode():
        o = tatt.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is None and not o.requires_grad


def test_noncontiguous_output_gradient():
    """The transformer transposes the output right after the call, so the
    gradient reaches the backward as a permuted view."""
    q, k, v = _qkv(2, 2, 64, 64, 16, seed=82)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tatt.flash_attention(*ts, causal=True).transpose(1, 2)
    g = torch.from_numpy(_arrays([o.shape], seed=83)[0])
    got = torch.autograd.grad(o, ts, g)
    refs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(
        tatt.mha_reference(*refs, causal=True).transpose(1, 2), refs, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_wrappers_cpu_path_is_the_plain_version(causal):
    q, k, v, do = (torch.from_numpy(a)
                   for a in _arrays([(1, 2, 96, 32)] * 4, seed=84))
    o, lse = tatt.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do * o).sum(-1)
    want = tatt.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    dq = tatt.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tatt.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "do_noncontig",
                                 "lse_dtype", "delta_shape"])
def test_bwd_wrappers_reject_what_the_kernels_do_not_take(bad):
    q, k, v, do = (torch.from_numpy(a)
                   for a in _arrays([(1, 2, 32, 16)] * 4, seed=85))
    lse = torch.zeros(1, 2, 32)
    delta = torch.zeros(1, 2, 32)
    if bad == "do_shape":
        do = do[:, :, :16].contiguous()
    elif bad == "do_dtype":
        do = do.to(torch.bfloat16)
    elif bad == "do_noncontig":
        do = do.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "lse_dtype":
        lse = lse.double()
    else:
        delta = delta[:, :, :8]
    for fn in (tatt.flash_attention_bwd_dq, tatt.flash_attention_bwd_dkv):
        with pytest.raises(MXNetError):
            fn(q, k, v, do, lse, delta)


@pytest.mark.parametrize("d", (8, 24, 96, 160, 256))
def test_grads_any_head_dim_match_jax_flash_kernels(d):
    """Gradients at head dims off the card's buckets and at the largest
    one, against jax.grad of the Pallas kernels in interpret mode."""
    q, k, v = _qkv(1, 2, 128, 128, d, seed=90 + d)

    def flash(q, k, v):
        return att.flash_attention(q, k, v, causal=True, interpret=True,
                                   block_q=64, block_k=64)

    want = _jax_grads(flash, q, k, v)
    got = _port_grads(q, k, v, causal=True)
    assert all(g.shape == (1, 2, 128, d) for g in got)
    _assert_all_close(got, want, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_float16_grads_match_jax_flash_kernels(causal):
    """float16 q, k, v: the gradients in float16 against jax.grad of the
    JAX package's float16 flash attention (Pallas, interpret mode)."""
    q, k, v = _qkv(1, 2, 128, 128, 32, seed=95)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.float16) for a in (q, k, v))

    def loss(q, k, v):
        o = att.flash_attention(q, k, v, causal=causal, interpret=True,
                                block_q=64, block_k=64).astype(jnp.float32)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [torch.from_numpy(a).half().requires_grad_() for a in (q, k, v)]
    o = tatt.flash_attention(*ts, causal=causal).float()
    got = torch.autograd.grad((o * torch.cos(o)).sum(), ts)
    assert all(g.dtype == torch.float16 for g in got)
    _assert_all_close(got, want, dict(rtol=2e-2, atol=2e-2))


# -- the card's backward kernels: launch plan and rounding points ----------
#
# chip_smoke.py holds the kernels to the plain backward within these
# (its BWD_TOL, abs + rel); the emulations below are held to them against
# the JAX package's backward kernels before the card.
CARD_BWD_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2,
                torch.float16: 1e-2}
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bwd_launch_plan_agrees_with_head_dim_buckets(dtype):
    """Every head dim the card takes gets its bucket's plan, on the route
    of its bucket and type, in a block's 227 KB of shared memory."""
    for d in range(1, tatt.MAX_HEAD_DIM + 1):
        plan = tatt.bwd_launch_plan(d, dtype)
        assert plan.bucket == tatt.head_dim_bucket(d)
        want = ("cuda_cores" if plan.bucket == 256 else
                "tf32x3" if dtype == torch.float32 else "wgmma")
        assert plan.route == want
        assert max(plan.dq_smem, plan.dkv_smem) <= 232448
        assert plan.threads == (256 if plan.route == "cuda_cores" else 128)
    with pytest.raises(MXNetError):
        tatt.bwd_launch_plan(tatt.MAX_HEAD_DIM + 1, dtype)


def _tf32_split(x):
    """(hi, lo) as the 3xTF32 kernels split float32 ``x``: hi rounded to
    tf32 on the bits (+ half an ulp of tf32, then the low 13 bits cleared:
    to nearest, ties away from zero, as cvt.rna.tf32.f32), lo = x - hi as
    the tensor core reads it, its low 13 bits dropped."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -8192).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def _mm_3xtf32(spec, a, b):
    """``einsum(spec, a, b)`` as lo*hi + hi*lo + hi*hi over tf32 halves,
    each product exact and summed in float32."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)
            + torch.einsum(spec, ah, bh))


def _kernel_rounding_bwd(q, k, v, o, lse, do, causal, scale):
    """The card's backward with the kernels' rounding points: float32 with
    every product 3xTF32; bf16 and float16 with every product in float32
    from the 16-bit inputs and P and dS rounded to the input type before
    the second products.  Gradients in the input type."""
    dt = q.dtype
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    mm = _mm_3xtf32 if dt == torch.float32 else torch.einsum
    s = mm("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        sq, sk = s.shape[-2:]
        s = s.masked_fill(torch.arange(sk) > torch.arange(sq)[:, None],
                          -1e30)
    p = torch.exp(s - lse.unsqueeze(-1))
    delta = (dof * o.float()).sum(-1)
    dp = mm("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    if dt != torch.float32:
        p, ds = p.to(dt).float(), ds.to(dt).float()
    dq = mm("bhqk,bhkd->bhqd", ds, kf)
    dk = mm("bhqk,bhqd->bhkd", ds, qf)
    dv = mm("bhqk,bhqd->bhkd", p, dof)
    return tuple(g.to(dt) for g in (dq, dk, dv))


def _emulation_against_pallas(b, h, sq, sk, d, causal, dtype, block, seed):
    q, k, v, do = (a.astype(np.float32) for a in _arrays(
        [(b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d)], seed))
    jq, jk, jv, jdo = (jnp.asarray(a, dtype=_JNP[dtype])
                       for a in (q, k, v, do))
    scale = 1.0 / np.sqrt(d)
    o, lse = att._fwd_pallas(jq, jk, jv, scale, causal, block, block, True)
    want = att._bwd_pallas(jq, jk, jv, o, lse, jdo, scale, causal, block,
                           block, True)

    def port(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)

    got = _kernel_rounding_bwd(port(jq), port(jk), port(jv), port(o),
                               torch.from_numpy(np.asarray(lse)), port(jdo),
                               causal, scale)
    tol = CARD_BWD_TOL[dtype]
    _assert_all_close(got, [np.asarray(w, dtype=np.float32) for w in want],
                      dict(rtol=tol, atol=tol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(1, 2, 128, 128, 32, False, 64),
                                   (1, 2, 128, 128, 32, True, 64),
                                   (1, 1, 100, 100, 24, True, 20)],
                         ids=["non-causal", "causal", "ragged"])
def test_kernel_rounding_points_match_jax_bwd_kernels(dtype, shape):
    """The rounding points of the card's kernels (3xTF32 products in
    float32; P and dS rounded to bf16 or float16 before the second
    products) against _bwd_pallas in interpret mode, within the card's
    tolerance: the accuracy of the tensor-core routes, checked on the CPU.
    S = 100 is ragged for the card's 64-row tiles (Pallas runs it in
    blocks of 20)."""
    b, h, sq, sk, d, causal, block = shape
    _emulation_against_pallas(b, h, sq, sk, d, causal, dtype, block,
                              seed=110 + sq + causal)


@pytest.mark.parametrize("d", [96, 256])
def test_3xtf32_rounding_points_wide_heads_match_jax_bwd_kernels(d):
    """3xTF32 at a head dim between buckets and at the largest, held to the
    card's float32 tolerance (2e-3) against _bwd_pallas."""
    _emulation_against_pallas(1, 2, 128, 128, d, True, torch.float32, 64,
                              seed=120 + d)


@pytest.mark.parametrize("d", [32, 96, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_backward_is_float32_accurate(d, causal):
    """The 3xTF32 route against the float32 plain backward on the same
    operands, at 2e-5: its products are within 2^-20 of float32's, where
    one TF32 pass (which the card does not take) is about 1e-3 off here."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        [(1, 2, 128, d)] * 4, seed=140 + d + causal))
    o, lse = tatt.flash_attention(q, k, v, causal=causal, return_lse=True)
    want = tatt.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    got = _kernel_rounding_bwd(q, k, v, o, lse, do, causal, 1 / np.sqrt(d))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_3xtf32_split_is_float32_accurate():
    """hi + lo reproduces float32 values to 2^-20 relative, and hi is
    rounded to nearest with ties away from zero on tf32's 10 bits."""
    x = torch.from_numpy(np.random.RandomState(130).normal(
        size=4096).astype(np.float32) * 100)
    hi, lo = _tf32_split(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((x - hi - lo).abs() <= x.abs() * 2.0 ** -20)
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _tf32_split(tie)[0].tolist() == [1.0 + 2.0 ** -10,
                                            -(1.0 + 2.0 ** -10)]


def test_variant_build_raises_without_a_kernel_to_build(tmp_path):
    """The probes' variant build raises MXNetError, naming the cause, when
    nvcc is missing (as on this CPU host) or the source does not build."""
    from mxnet_tpu_torch import _kernels

    assert _kernels.build_variants("flash_attn_bwd", []) == {}
    with pytest.raises(MXNetError):
        _kernels.build_variants("flash_attn_bwd",
                                [str(tmp_path / "missing.cu")])
