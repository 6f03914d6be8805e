"""The port's CTC loss (the ``CTCLoss``/``ctc_loss`` op and
``gluon.loss.CTCLoss``) against the JAX package's, on the CPU.

The same seeded activations and labels go through both ops: the blank
first (labels 1-based, padded with 0) and last (0-based, padded with -1),
with and without each length input, a zero-length label, repeated labels
(which need a blank between them), a sequence that stops early; the
gradient against ``jax.grad``.  Tolerances: the loss within 1e-5 of its
largest magnitude, the gradient within 1e-4 of its largest magnitude.

A label that its data length cannot hold (the last sample's two 3s in 2
steps, with the data lengths in use) has no path: its loss sits at the
-1e30 floor's 1e30 in both packages, and its gradient is held out: at
the floor ``logaddexp``'s arguments are absorbed, and JAX's derivative
there gives each of two equal arguments 1 (the pair 2), PyTorch's 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgl
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import nn as tnn

T_, N, C = 12, 5, 6
# per sample: repeated labels, a run of one label, an empty label, the
# longest label, a label longer than its data length allows
LABELS = [[1, 2, 2, 3, 0], [4, 4, 4, 0, 0], [0, 0, 0, 0, 0],
          [5, 1, 5, 1, 5], [3, 3, 0, 0, 0]]
DATA_LENGTHS = [12, 9, 5, 12, 2]
LABEL_LENGTHS = [4, 3, 0, 5, 2]


def _inputs(blank, seed=0):
    rng = np.random.RandomState(seed)
    data = rng.randn(T_, N, C).astype(np.float32)
    label = np.array(LABELS, np.float32)
    if blank == "last":  # 0-based labels, -1 padding
        label = np.where(label > 0, label - 1, -1).astype(np.float32)
    return (data, label, np.array(DATA_LENGTHS, np.float32),
            np.array(LABEL_LENGTHS, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("use_data", [False, True])
@pytest.mark.parametrize("use_label", [False, True])
def test_ctc_loss_and_gradient_match_jax(blank, use_data, use_label):
    data, label, dl, ll = _inputs(blank)
    kw = dict(blank_label=blank, use_data_lengths=use_data,
              use_label_lengths=use_label)
    lens = [dl if use_data else None, ll if use_label else None]

    def jloss(d):
        return jnn.ctc_loss(d, jnp.asarray(label),
                            *[None if a is None else jnp.asarray(a)
                              for a in lens], **kw)

    want = np.asarray(jloss(jnp.asarray(data)))
    path = np.flatnonzero(want < 1e29)  # the samples a path can align
    assert len(path) == N - int(use_data)
    want_grad = np.asarray(jax.grad(lambda d: jloss(d)[path].sum())(
        jnp.asarray(data)))
    x = torch.tensor(data, requires_grad=True)
    got = tnn.ctc_loss(x, torch.from_numpy(label),
                       *[None if a is None else torch.from_numpy(a)
                         for a in lens], **kw)
    got[torch.from_numpy(path)].sum().backward()
    assert got.shape == (N,)
    _close(got.detach().numpy()[path], want[path], 1e-5)
    np.testing.assert_array_equal(got.detach().numpy() >= 1e29, want >= 1e29)
    _close(x.grad.numpy(), want_grad, 1e-4)


def test_label_lengths_alone_may_come_third():
    """The reference contracts its input list by the use_* flags: with
    only the label lengths in use, they are the third input."""
    data, label, _, ll = _inputs("first")
    args = [torch.from_numpy(a) for a in (data, label, ll)]
    third = tnn.ctc_loss(*args, use_label_lengths=True)
    fourth = tnn.ctc_loss(args[0], args[1], None, args[2],
                          use_label_lengths=True)
    assert torch.equal(third, fourth)
    want = jnn.ctc_loss(*[jnp.asarray(a) for a in (data, label, ll)],
                        use_label_lengths=True)
    _close(third.numpy(), np.asarray(want), 1e-5)
    # and through mx.nd, both names
    nd_args = [tnd.array(a, ctx="cpu") for a in (data, label, ll)]
    for op in (tnd.CTCLoss, tnd.ctc_loss):
        out = op(*nd_args, use_label_lengths=True)
        assert torch.equal(out.data_torch, third)


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN")])
@pytest.mark.parametrize("lengths", [False, True])
def test_gluon_ctc_loss_matches_jax(layout, label_layout, lengths):
    data, label, dl, ll = _inputs("last", seed=1)
    if layout == "NTC":
        data = np.ascontiguousarray(data.transpose(1, 0, 2))
    if label_layout == "TN":
        label = np.ascontiguousarray(label.T)
    weight = np.linspace(0.5, 1.5, N).astype(np.float32)[:, None]
    if lengths:  # the last sample has no path in its 2 steps
        dl[-1] = T_
    jl = jgl.loss.CTCLoss(layout, label_layout, weight=0.7)
    tl = gluon.loss.CTCLoss(layout, label_layout, weight=0.7)
    extra = (dl, ll) if lengths else (None, None)
    want = jl(mx.nd.array(data), mx.nd.array(label),
              *[None if a is None else mx.nd.array(a) for a in extra],
              mx.nd.array(weight[:, 0])).asnumpy()
    got = tl(torch.from_numpy(data), torch.from_numpy(label),
             *[None if a is None else torch.from_numpy(a) for a in extra],
             torch.from_numpy(weight[:, 0]))
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)


def test_bad_layout_raises():
    with pytest.raises(ValueError):
        gluon.loss.CTCLoss("NCT")
