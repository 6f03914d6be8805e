"""The port's BatchNorm (mxnet_tpu_torch/ops/nn.py batch_norm and the
gluon.nn.BatchNorm layer) against the JAX package, on the CPU.

Tolerances:
- float32: 1e-5 (rtol and atol), the mean and the two-pass variance
  summed in another order by each package;
- bf16 data: one bf16 step (2**-7 relative, plus 1e-2 absolute for
  outputs near 0) for the output, the mean and the variance: both
  packages sum E[x] and E[x^2] in float32 and round the results to bf16,
  and a float32 sum in another order may land one bf16 step away;
- the running statistics (float32 in both): 1e-5, and one bf16 step
  times (1 - momentum) where the batch statistics are bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd
from mxnet_tpu.gluon import nn as jgnn
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.ops import nn as tnn

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -7, atol=1e-2)


def _inputs(shape, axis, seed=0):
    rs = np.random.RandomState(seed)
    c = shape[axis]
    x = (rs.normal(size=shape) * 2 + 0.5).astype(np.float32)
    stats = [rs.normal(size=c).astype(np.float32) for _ in range(3)]
    stats.append(rs.rand(c).astype(np.float32) + 0.5)  # moving var
    return x, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis,shape", [(3, (4, 5, 6, 8)), (1, (4, 8, 5, 6)),
                                        (-1, (6, 16))])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("use_global_stats", [False, True])
def test_batch_norm_op_matches_jax(dtype, axis, shape, fix_gamma,
                                   use_global_stats):
    x, (gamma, beta, mm, mv) = _inputs(shape, axis)
    jx = jnp.asarray(x).astype(dtype)
    want = jnn.batch_norm(jx, *(jnp.asarray(a) for a in (gamma, beta, mm, mv)),
                          eps=1e-5, fix_gamma=fix_gamma,
                          use_global_stats=use_global_stats,
                          output_mean_var=True, axis=axis)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tnn.batch_norm(tx, *(torch.from_numpy(a)
                               for a in (gamma, beta, mm, mv)),
                         eps=1e-5, fix_gamma=fix_gamma,
                         use_global_stats=use_global_stats, axis=axis)
    tol = F32 if dtype == "float32" else BF16
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)


def test_batch_norm_op_gradients_match_jax():
    x, (gamma, beta, mm, mv) = _inputs((4, 5, 6, 8), 3, seed=1)

    def jfn(x_, g_, b_):
        return jnn.batch_norm(x_, g_, b_, jnp.asarray(mm), jnp.asarray(mv),
                              eps=1e-5, fix_gamma=False, axis=3)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, gamma, beta)))
    dy = np.random.RandomState(2).normal(size=want.shape).astype(np.float32)
    wgrads = vjp(jnp.asarray(dy))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    out, _, _ = tnn.batch_norm(tx, tg, tb, torch.from_numpy(mm),
                               torch.from_numpy(mv), eps=1e-5,
                               fix_gamma=False, axis=3)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32)
    for t, w in zip((tx, tg, tb), wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _layers(c):
    jl = jgnn.BatchNorm(axis=3, in_channels=c)
    jl.initialize()
    tl = tgnn.BatchNorm(axis=3, in_channels=c, device="cpu").initialize()
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == {
        k: (c,) for k in ("gamma", "beta", "running_mean", "running_var")}
    assert [p.grad_req for p in tl.collect_params().values()] == [
        "write", "write", "null", "null"]
    return jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_updates_running_stats_in_train_mode_as_jax(dtype):
    """Two train-mode calls fold the batch statistics into the running
    ones (momentum 0.9, biased variance); predict mode then normalises
    by them.  The running statistics stay float32."""
    c = 8
    jl, tl = _layers(c)
    xs = [(np.random.RandomState(s).normal(size=(4, 5, 5, c)) * 3 + 1)
          .astype(np.float32) for s in (3, 4)]
    for x in xs:
        jx = nd.array(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        with jag.record():
            want = jl(jx)
        with tag.record():
            got = tl(tx)
        tol = F32 if dtype == "float32" else BF16
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   want.astype("float32").asnumpy(), **tol)
    batch = {"running_mean": [x.mean(axis=(0, 1, 2)) for x in xs],
             "running_var": [x.var(axis=(0, 1, 2)) for x in xs]}
    for name in ("running_mean", "running_var"):
        got = getattr(tl, name)
        assert got.dtype == torch.float32 and not got.requires_grad
        want = getattr(jl, name).data().asnumpy()
        if dtype == "float32":
            np.testing.assert_allclose(got.detach().numpy(), want, **F32)
        else:  # one bf16 step of each batch statistic, times 1 - momentum
            bound = sum(0.1 * 2.0 ** -7 * np.abs(b) for b in batch[name])
            assert (np.abs(got.detach().numpy() - want) <= bound + 1e-6).all()
    # the running variance folded in the biased batch variance
    if dtype == "float32":
        want_var = 1.0
        for x in xs:
            want_var = want_var * 0.9 + x.var(axis=(0, 1, 2)) * 0.1
        np.testing.assert_allclose(tl.running_var.detach().numpy(), want_var,
                                   rtol=1e-5)
    # predict mode, from the JAX layer's running statistics: they are
    # used, and not updated
    with torch.no_grad():
        for name in ("running_mean", "running_var"):
            getattr(tl, name).copy_(torch.from_numpy(
                getattr(jl, name).data().asnumpy()))
    x = xs[0]
    before = tl.running_mean.detach().clone()
    want = jl(nd.array(x)).asnumpy()
    got = tl(torch.from_numpy(x))
    assert torch.equal(tl.running_mean.detach(), before)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_layer_use_global_stats_and_fixed_gamma():
    tl = tgnn.BatchNorm(axis=3, in_channels=4, scale=False, center=False,
                        use_global_stats=True, device="cpu").initialize()
    assert tl.gamma.grad_req == "null" and tl.beta.grad_req == "null"
    with torch.no_grad():
        tl.gamma.fill_(5.0)  # ignored: fix_gamma
        tl.running_var.fill_(4.0)
    x = torch.full((2, 3, 3, 4), 2.0)
    with tag.record():
        out = tl(x)
    assert torch.equal(tl.running_mean.detach(), torch.zeros(4))
    torch.testing.assert_close(out, x / torch.sqrt(torch.tensor(4.0 + 1e-5)))
