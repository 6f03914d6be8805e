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
the Pallas kernels against ``jax.grad`` of the reference.
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
