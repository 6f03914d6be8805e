"""``mx.operator`` custom ops and ``Custom`` in the port against the JAX
package on the CPU.

The same user code (``CustomOp``/``CustomOpProp`` subclasses made from
either package's ``mx.operator``) is registered in both packages: a
host-numpy softmax whose backward is ``p - onehot(label)``
(``example/numpy-ops/custom_softmax.py``, ``need_top_grad=False``), and a
two-output op.  Held: ``mx.nd`` calls under ``autograd.record`` (values
and gradients within 1e-6), the symbol's arguments, the ``infer_shape``
and ``infer_type`` of a graph that holds one, 10 SGD steps through
``Module`` from carried parameters (every parameter within 1e-5 of the
JAX package's largest magnitude), ``assign``'s requests, and that an
executor of such a graph is never captured.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager

CPU = tmx.cpu()
SOFTMAX, TWO = "_test_numpy_softmax", "_test_two_outputs"


def _register(mx):
    """The test's ops, registered with ``mx.operator`` (either package)."""

    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().ravel().astype(np.int64)
            p = out_data[0].asnumpy().copy()
            p[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], p)

    @mx.operator.register(SOFTMAX)
    class NumpySoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()

    class Two(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], 2.0 * x)
            self.assign(out_data[1], req[1], x * x)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0].asnumpy()
            self.assign(in_grad[0], req[0], 2.0 * out_grad[0].asnumpy()
                        + 2.0 * x * out_grad[1].asnumpy())

    @mx.operator.register(TWO)
    class TwoProp(mx.operator.CustomOpProp):
        def list_outputs(self):
            return ["double", "square"]

        def create_operator(self, ctx, shapes, dtypes):
            return Two()


_register(jmx)
_register(tmx)


def _mlp(mx, nm):
    with nm():
        h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                  name="fc1")
        h = mx.sym.Activation(h, act_type="relu")
        h = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
        return mx.sym.Custom(data=h, name="softmax", op_type=SOFTMAX)


def test_nd_call_under_record_equals_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 5).astype(np.float32)
    label = rs.randint(0, 5, 4).astype(np.float32)
    got = {}
    for name, mx, ctx in (("jax", jmx, jmx.cpu()), ("port", tmx, CPU)):
        a = mx.nd.array(x, ctx=ctx)
        a.attach_grad()
        lab = mx.nd.array(label, ctx=ctx)
        with mx.autograd.record():
            p = getattr(mx.nd, SOFTMAX)(a, lab)
        p.backward()
        b = mx.nd.array(x, ctx=ctx)
        b.attach_grad()
        with mx.autograd.record():
            d, s = mx.nd.Custom(b, op_type=TWO)
            loss = d * 3.0 + s
        loss.backward()
        got[name] = [v.asnumpy() for v in (p, a.grad, d, s, b.grad)]
    for g, w in zip(got["port"], got["jax"]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    # need_top_grad=False: the op's own gradient, whatever the head's
    p = got["port"][0].copy()
    p[np.arange(4), label.astype(int)] -= 1
    np.testing.assert_allclose(got["port"][1], p, rtol=1e-6, atol=1e-7)
    # outside record: no graph, the same values
    out = tmx.nd.Custom(tmx.nd.array(x, ctx=CPU), op_type=TWO)
    np.testing.assert_array_equal(out[1].asnumpy(), got["port"][3])


def test_symbol_arguments_shapes_and_types_equal_jax():
    jsym, tsym = _mlp(jmx, JNameManager), _mlp(tmx, TNameManager)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_arguments()[-1] == "softmax_label"
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.infer_shape(data=(8, 20)) == jsym.infer_shape(data=(8, 20))
    _, outs, _ = tsym.infer_shape(data=(8, 20))
    assert outs == [(8, 10)]
    assert tsym.infer_type(np.float32)[1] == [np.dtype(np.float32)]
    two = tmx.sym.Custom(tmx.sym.Variable("x"), op_type=TWO, name="two")
    jtwo = jmx.sym.Custom(jmx.sym.Variable("x"), op_type=TWO, name="two")
    assert two.list_outputs() == jtwo.list_outputs() == ["two_output0",
                                                         "two_output1"]
    assert two.infer_shape(x=(3, 2))[1] == [(3, 2), (3, 2)]
    with pytest.raises(MXNetError, match="not registered"):
        tmx.sym.Custom(tmx.sym.Variable("x"), op_type="_no_such_op")


def test_module_trajectory_equals_jax_and_is_not_captured():
    it = tmx.io.MNISTIter(batch_size=16, shuffle=False, flat=True)
    batches = [next(it) for _ in range(4)]
    data = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in batches]
    params, runs = None, {}
    for name, mx, nm, ctx in (("jax", jmx, JNameManager, jmx.cpu()),
                              ("port", tmx, TNameManager, CPU)):
        mod = mx.mod.Module(_mlp(mx, nm), context=ctx)
        mod.bind([("data", (16, 784))], [("softmax_label", (16,))])
        if params is None:
            mx.random.seed(1)
            mod.init_params(mx.init.Xavier())
            params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        else:
            mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                        for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        metric = mx.metric.Accuracy()
        for i in range(10):
            x, y = data[i % len(data)]
            batch = mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                    [mx.nd.array(y, ctx=ctx)])
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
        runs[name] = ({k: v.asnumpy() for k, v in mod.get_params()[0]
                       .items()}, metric.get()[1], mod)
    (jp, jacc, _), (tp, tacc, tmod) = runs["jax"], runs["port"]
    for k, w in jp.items():
        assert np.abs(w - params[k]).max() > 1e-3, k
        np.testing.assert_allclose(tp[k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    assert tacc == jacc
    ex = tmod._exec_group.execs[0]
    assert not tmx.executor.graph_capturable(ex._symbol)
    assert ex.route == "eager, fused"
    assert tmx.executor.graph_capturable(tmx.sym.SoftmaxOutput(
        tmx.sym.Variable("data"), name="softmax"))


@pytest.mark.parametrize("req,want", [("write", 5.0), ("inplace", 5.0),
                                      ("add", 7.0), ("null", 2.0)])
def test_assign_follows_req(req, want):
    dst = tmx.nd.full((2, 2), 2.0, ctx=CPU)
    tmx.operator.CustomOp().assign(dst, req, np.full((2, 2), 5.0))
    np.testing.assert_array_equal(dst.asnumpy(), np.full((2, 2), want))
