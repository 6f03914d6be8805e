"""``hybrid_forward`` blocks, ``export`` and ``SymbolBlock`` of the PyTorch
port against the JAX package.

A user block written as ``hybrid_forward(F, x, **params)`` gives the same
values called on NDArrays (``F`` = ``mx.nd``), on tensors (``F`` the
registered ops over tensors) and hybridized; its outputs and gradients,
from parameters carried across by ``save_parameters``, are within 1e-5
of the JAX package's.  ``export`` crosses both ways: the port's files
load in the JAX package's ``SymbolBlock.imports`` and the JAX package's
in the port's, outputs within 1e-5; the port's ``SymbolBlock`` is
differentiable (the JAX package's is not).  Inputs are seeded numpy
arrays.
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5


def _user_block(mx):
    """A block with its own parameter (a per-feature gain) around two
    layers, written once for both packages."""

    class Gated(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.fc = mx.gluon.nn.Dense(6, in_units=5)
                self.out = mx.gluon.nn.Dense(3, in_units=6)
                self.gain = self.params.get("gain", shape=(6,),
                                            init=mx.init.One())

        def hybrid_forward(self, F, x, gain):
            h = F.broadcast_mul(F.tanh(self.fc(x)),
                                F.reshape(gain, shape=(1, 6)))
            return self.out(F.relu(h) - F.mean(h))

    return Gated(prefix="gated_")


def _cnn(mx, dropout=True):
    """Every layer with a Symbol path in one stack: NCHW convolution with
    an activation, BatchNorm, max and average pools, Flatten, Dropout
    (unless not ``dropout``: the JAX package's predict-mode Dropout cuts
    the gradient, ROADMAP Queue 3) and Dense."""
    net = mx.gluon.nn.HybridSequential(prefix="cnn_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, in_channels=2,
                                   activation="relu"),
                mx.gluon.nn.BatchNorm(in_channels=4),
                mx.gluon.nn.MaxPool2D(2),
                mx.gluon.nn.Conv2D(6, 3, in_channels=4, use_bias=False),
                mx.gluon.nn.Activation("sigmoid"),
                mx.gluon.nn.AvgPool2D(2, 1),
                mx.gluon.nn.Flatten(),
                mx.gluon.nn.Dropout(0.5 if dropout else 0.0),
                mx.gluon.nn.Dense(3, in_units=6))
    return net


def _pair(make, x, tmp_path):
    jnet = make(jmx)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    path = str(tmp_path / "net.params")
    jnet.save_parameters(path)
    with tmx.cpu():
        tnet = make(tmx)
    tnet.load_parameters(path)
    return tnet, jnet


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_ndarray_tensor_and_hybridized_calls_agree(tmp_path):
    x = _x((4, 5))
    tnet, _ = _pair(_user_block, x, tmp_path)
    with tmx.cpu():
        nd_out = tnet(tmx.nd.array(x))
    assert isinstance(nd_out, tmx.nd.NDArray)
    t_out = tnet(torch.from_numpy(x))
    assert isinstance(t_out, torch.Tensor)
    np.testing.assert_allclose(nd_out.asnumpy(), t_out.numpy(), rtol=0,
                               atol=1e-6)
    tnet.hybridize()
    with tmx.cpu():
        hyb_nd = tnet(tmx.nd.array(x))
    hyb_t = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(hyb_nd.asnumpy(), t_out.numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(hyb_t, torch.from_numpy(hyb_nd.asnumpy()))
    assert len(tnet._cached_graphs) == 1


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("make,shape", [
    (_user_block, (4, 5)), (lambda mx: _cnn(mx, dropout=False), (2, 2, 8, 8))],
                         ids=["user", "cnn"])
def test_outputs_and_gradients_match_jax(make, shape, hybrid, tmp_path):
    x = _x(shape, 1)
    tnet, jnet = _pair(make, x, tmp_path)
    if hybrid:
        tnet.hybridize()
        jnet.hybridize()
    with tmx.cpu():
        tx = tmx.nd.array(x)
        with tmx.autograd.record(train_mode=False):
            tout = tnet(tx)
        tout.backward()
    jx = jmx.nd.array(x)
    with jmx.autograd.record(train_mode=False):
        jout = jnet(jx)
    jout.backward()
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=0,
                               atol=TOL)
    for name, p in jnet.collect_params().items():
        if p.grad_req == "null":
            continue
        np.testing.assert_allclose(
            tnet.collect_params()[name].grad().asnumpy(),
            p.grad().asnumpy(), rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("make,shape", [(_user_block, (4, 5)),
                                        (_cnn, (2, 2, 8, 8))],
                         ids=["user", "cnn"])
def test_export_crosses_both_ways(make, shape, tmp_path):
    x = _x(shape, 2)
    tnet, jnet = _pair(make, x, tmp_path)
    want = jnet(jmx.nd.array(x)).asnumpy()
    # the port's export, loaded by the JAX package
    tnet.export(str(tmp_path / "port"))
    assert os.path.exists(str(tmp_path / "port-symbol.json"))
    jsb = jmx.gluon.SymbolBlock.imports(str(tmp_path / "port-symbol.json"),
                                        ["data"],
                                        str(tmp_path / "port-0000.params"))
    np.testing.assert_allclose(jsb(jmx.nd.array(x)).asnumpy(), want,
                               rtol=0, atol=TOL)
    # the JAX package's export, loaded by the port
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    jnet.export(str(tmp_path / "jax"), epoch=3)
    with tmx.cpu():
        tsb = tmx.gluon.SymbolBlock.imports(
            str(tmp_path / "jax-symbol.json"), ["data"],
            str(tmp_path / "jax-0003.params"))
        got = tsb(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the port's own export reloads bitwise into the port
    with tmx.cpu():
        own = tmx.gluon.SymbolBlock.imports(
            str(tmp_path / "port-symbol.json"), "data",
            str(tmp_path / "port-0000.params"))
        assert np.array_equal(own(tmx.nd.array(x)).asnumpy(),
                              tnet(tmx.nd.array(x)).asnumpy())


def test_symbol_block_is_differentiable_and_keeps_the_aux_names(tmp_path):
    x = _x((2, 2, 8, 8), 3)
    tnet, _ = _pair(_cnn, x, tmp_path)
    tnet.export(str(tmp_path / "cnn"))
    with tmx.cpu():
        sb = tmx.gluon.SymbolBlock.imports(str(tmp_path / "cnn-symbol.json"),
                                           ["data"],
                                           str(tmp_path / "cnn-0000.params"))
    names = list(sb.collect_params())
    assert set(names) == set(tnet.collect_params())
    assert sb.collect_params()["cnn_batchnorm0_running_mean"].grad_req \
        == "null"
    for block in (tnet, sb):
        with tmx.autograd.record(train_mode=False):
            out = block(torch.from_numpy(x))
        tmx.autograd.backward(out)
    for name in ("cnn_conv2d0_weight", "cnn_dense0_bias"):
        np.testing.assert_allclose(
            sb.collect_params()[name].grad().asnumpy(),
            tnet.collect_params()[name].grad().asnumpy(), rtol=0, atol=TOL)
    # a train-mode call moves the moving statistics, as the layer does
    before = sb.collect_params()["cnn_batchnorm0_running_var"].data() \
        .asnumpy().copy()
    with tmx.autograd.record():
        sb(torch.from_numpy(x))
    assert not np.array_equal(
        sb.collect_params()["cnn_batchnorm0_running_var"].data().asnumpy(),
        before)


def test_a_layer_without_a_symbol_path_raises():
    # the fused recurrent layer, which the JAX package cannot trace either
    with tmx.cpu():
        lstm = tmx.gluon.rnn.LSTM(4, input_size=3)
    with pytest.raises(MXNetError, match="JAX package has none either"):
        lstm(tmx.sym.Variable("data"))
    with tmx.cpu():
        dense = tmx.gluon.nn.Dense(2, in_units=4)
    sym = dense(tmx.sym.Variable("data"))
    assert sym.list_arguments() == ["data", dense.weight.name,
                                    dense.bias.name]


def _methods_block(mx):
    """A user block that calls NDArray methods on its input, whose MXNet
    meaning differs from PyTorch's: ``flatten`` keeps the batch axis,
    ``reshape`` takes 0 for "keep this dimension"."""

    class Methods(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.fc = mx.gluon.nn.Dense(3, in_units=12)

        def hybrid_forward(self, F, x):
            x = x.astype("float32")
            h = x.reshape((0, -1)) + 2 * x.flatten()
            return self.fc(h).expand_dims(1)

    return Methods(prefix="methods_")


@pytest.mark.parametrize("call", ["ndarray", "tensor"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_user_block_sees_ndarray_methods_in_every_mode(hybrid, call,
                                                       tmp_path):
    """A user block gets NDArrays with MXNet's methods whether it is
    hybridized or not and whether it was called with NDArrays or
    tensors: outputs and gradients within TOL of the JAX package's."""
    x = _x((2, 3, 2, 2), 4)
    tnet, jnet = _pair(_methods_block, x, tmp_path)
    if hybrid:
        tnet.hybridize()
        jnet.hybridize()
    with tmx.cpu():
        tx = tmx.nd.array(x) if call == "ndarray" else torch.from_numpy(x)
        with tmx.autograd.record(train_mode=False):
            tout = tnet(tx)
        tmx.autograd.backward(tout)
    tout = tout.asnumpy() if call == "ndarray" else tout.detach().numpy()
    jx = jmx.nd.array(x)
    with jmx.autograd.record(train_mode=False):
        jout = jnet(jx)
    jout.backward()
    assert tout.shape == (2, 1, 3)
    np.testing.assert_allclose(tout, jout.asnumpy(), rtol=0, atol=TOL)
    for name, p in jnet.collect_params().items():
        np.testing.assert_allclose(
            tnet.collect_params()[name].grad().asnumpy(),
            p.grad().asnumpy(), rtol=0, atol=TOL, err_msg=name)


def test_deferred_user_block_infers_its_shape():
    class Scale(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="scale_")
            self.w = self.params.get("w", shape=(0,),
                                     init=tmx.init.Constant(2.0),
                                     allow_deferred_init=True)

        def infer_shape(self, x):
            self.w.shape = (x.shape[1],)

        def hybrid_forward(self, F, x, w):
            return F.broadcast_mul(x, F.reshape(w, shape=(1, -1)))

    with tmx.cpu():
        blk = Scale()
        blk.initialize()
        with pytest.raises(tmx.gluon.DeferredInitializationError):
            blk.w.data()
        out = blk(tmx.nd.ones((2, 3)))
    assert blk.w.shape == (3,) and (out.asnumpy() == 2).all()
