"""The port's TransformerLM (mxnet_tpu_torch/gluon/nn/transformer.py)
against the JAX package's, with the JAX model's initialised weights
carried across by mxnet_tpu_torch.convert.load_mxnet_tpu_params, both
from a dict and from a save_parameters file, on the CPU.

Tolerance: rtol = atol = 1e-4 on the logits; two layers of float32
products and softmaxes summed in another order by each package.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.nn.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.nn import TransformerLM

V, U, L, H, S = 97, 64, 2, 4, 64
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_lm():
    mx.random.seed(7)
    net = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S)
    net.initialize()
    net.hybridize()
    ids = np.random.RandomState(3).randint(-V, V, size=(3, S)) \
        .astype(np.float32)  # negative ids wrap, as in the JAX package
    logits = net(mx.nd.array(ids)).asnumpy()
    params = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    return net, ids, logits, params


def _port():
    return TransformerLM(V, units=U, num_layers=L, num_heads=H, max_length=S,
                         device="cpu")


def _forward(net, ids):
    with torch.inference_mode():
        return net(torch.from_numpy(ids)).numpy()


def test_state_dict_keys_are_jax_structural_names(jax_lm):
    _, _, _, params = jax_lm
    port = _port()
    assert list(port.state_dict()) == list(params)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} \
        == {k: v.shape for k, v in params.items()}


def test_logits_match_jax_from_dict(jax_lm):
    _, ids, want, params = jax_lm
    port = load_mxnet_tpu_params(_port(), params)
    got = _forward(port, ids)
    assert got.shape == (3, S, V) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_logits_match_jax_from_save_parameters_file(jax_lm, tmp_path):
    net, ids, want, _ = jax_lm
    path = str(tmp_path / "lm.params")
    net.save_parameters(path)
    port = _port()
    port.load_parameters(path)
    np.testing.assert_allclose(_forward(port, ids), want, **TOL)


def test_port_save_parameters_loads_into_jax(jax_lm, tmp_path):
    """The other direction: a port file is a JAX params file."""
    _, ids, _, _ = jax_lm
    port = _port().initialize(seed=5)
    path = str(tmp_path / "port.params")
    port.save_parameters(path)
    net = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S)
    net.initialize()
    net(mx.nd.array(ids))  # finish deferred shapes before loading
    net.load_parameters(path)
    np.testing.assert_allclose(_forward(port, ids),
                               net(mx.nd.array(ids)).asnumpy(), **TOL)


@pytest.mark.parametrize("bad", ["missing", "extra", "shape"])
def test_convert_checks_names_and_shapes(jax_lm, bad):
    _, _, _, params = jax_lm
    params = dict(params)
    if bad == "missing":
        params.pop("ln_f.beta")
    elif bad == "extra":
        params["logits.bias"] = np.zeros(V, np.float32)
    else:
        params["embed.weight"] = params["embed.weight"][:, :8]
    port = _port().initialize(seed=1)
    before = port.embed._parameters["weight"].detach().clone()
    with pytest.raises(MXNetError):
        load_mxnet_tpu_params(port, params)
    # nothing copied
    assert torch.equal(port.embed._parameters["weight"].detach(), before)


def test_initialize_is_seeded_and_follows_name_rules():
    a = _port().initialize(seed=11).state_dict()
    b = _port().initialize(seed=11).state_dict()
    c = _port().initialize(seed=12).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.weight"], c["embed.weight"])
    assert torch.equal(a["encoder.layers.0.attn.qkv.bias"],
                       torch.zeros(3 * U))
    assert torch.equal(a["ln_f.gamma"], torch.ones(U))
    assert a["logits.weight"].abs().max() <= 0.07


def test_head_dim_96_model_matches_jax():
    """TransformerLM(units=192, num_heads=2): head dim 96, which the JAX
    package serves (through its reference attention off the TPU) and the
    port's plain attention takes on the CPU; logits and the loss's
    gradient of every parameter against the JAX model's, each within 1e-4
    of its largest magnitude."""
    from mxnet_tpu import autograd as jautograd
    from mxnet_tpu_torch import autograd as tautograd

    mx.random.seed(9)
    net = JaxLM(V, units=192, num_layers=1, num_heads=2, max_length=32)
    net.initialize()
    ids = np.random.RandomState(4).randint(0, V, size=(2, 32)) \
        .astype(np.float32)
    want = net(mx.nd.array(ids)).asnumpy()
    params = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    port = load_mxnet_tpu_params(
        TransformerLM(V, units=192, num_layers=1, num_heads=2, max_length=32,
                      device="cpu"), params)
    got = _forward(port, ids)
    assert got.shape == (2, 32, V)
    np.testing.assert_allclose(got, want, **TOL)

    jparams = net._collect_params_with_prefix()
    with jautograd.record():
        jloss = (net(mx.nd.array(ids)) ** 2).mean()
    jloss.backward()
    want_g = {k: p.grad().asnumpy() for k, p in jparams.items()}
    with tautograd.record():
        loss = (port(torch.from_numpy(ids)) ** 2).mean()
    grads = dict(zip(port.state_dict(), torch.autograd.grad(
        loss, list(port.parameters()))))
    for k, w in want_g.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(grads[k].numpy() / scale, w / scale,
                                   rtol=0, atol=1e-4, err_msg=k)
