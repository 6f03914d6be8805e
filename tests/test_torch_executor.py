"""The port's Executor and loss heads against the JAX package's on the
CPU: the forward and every argument gradient of one fused backward for
the same parameters (crossed in the JAX package's npz file), within 1e-5
of each JAX array's largest magnitude; SoftmaxOutput's gradient for every
normalization, with ignore labels, label smoothing and multi-output; the
regression heads; BatchNorm's moving statistics; grad_req write, add and
null."""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from test_torch_symbol import build

TOL = 1e-5
CPU = tmx.cpu()
SHAPES = {"mlp": (4, 1, 28, 28), "lenet": (3, 1, 28, 28),
          "bn": (2, 3, 8, 8)}


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _values(sym, shapes, seed=0):
    """Arguments and aux states for ``sym``: random parameters and data,
    integer labels, positive variances."""
    rng = np.random.RandomState(seed)
    arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n.endswith("label"):
            classes = out_shapes[0][-1] if len(out_shapes[0]) > 1 else 2
            args[n] = rng.randint(0, classes, s).astype(np.float32)
        else:
            args[n] = (rng.randn(*s) * 0.3).astype(np.float32)
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("var")
               else rng.randn(*s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _crossed(args, aux, tmp_path):
    """The values through the JAX package's npz file, read by the port."""
    path = str(tmp_path / "params")
    jmx.nd.save(path, {**{"arg:" + k: jmx.nd.array(v)
                          for k, v in args.items()},
                       **{"aux:" + k: jmx.nd.array(v)
                          for k, v in aux.items()}})
    loaded = tmx.nd.load(path, ctx=CPU)
    return ({k[4:]: v for k, v in loaded.items() if k.startswith("arg:")},
            {k[4:]: v for k, v in loaded.items() if k.startswith("aux:")})


def _run(pkg, sym, args, aux, grad_req="write", train=True):
    mx = jmx if pkg == "jax" else tmx
    ctx = mx.cpu()
    ex = sym.bind(ctx, {k: mx.nd.array(np.asarray(
        v.asnumpy() if hasattr(v, "asnumpy") else v), ctx=ctx)
        for k, v in args.items()},
        args_grad={k: mx.nd.zeros(np.shape(v), ctx=ctx)
                   for k, v in args.items()},
        grad_req=grad_req,
        aux_states={k: mx.nd.array(np.asarray(
            v.asnumpy() if hasattr(v, "asnumpy") else v), ctx=ctx)
            for k, v in aux.items()})
    ex.forward(is_train=train)
    if train:
        ex.backward()
    outs = [o.asnumpy() for o in ex.outputs]
    grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()
             if g is not None}
    return ex, outs, grads, {k: a.asnumpy() for k, a in ex.aux_dict.items()}


@pytest.mark.parametrize("net", sorted(SHAPES))
def test_forward_and_gradients_equal_jax(net, tmp_path):
    jsym, tsym = build("jax", net), build("port", net)
    args, aux = _values(jsym, {"data": SHAPES[net]})
    targs, taux = _crossed(args, aux, tmp_path)
    _, jouts, jgrads, jaux = _run("jax", jsym, args, aux)
    ex, touts, tgrads, taux_after = _run("port", tsym, targs, taux)
    assert not ex.capture  # the CPU runs the fused program eagerly
    for g, w in zip(touts, jouts):
        _close(g, w)
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        _close(tgrads[k], jgrads[k])
    for k in jaux:
        _close(taux_after[k], jaux[k])
    assert ex.output_dict.keys() == {"softmax_output"} if net != "bn" \
        else {"linearregressionoutput0_output"}


@pytest.mark.parametrize("net", ["lenet", "bn"])
def test_predict_forward_equals_jax(net):
    jsym, tsym = build("jax", net), build("port", net)
    args, aux = _values(jsym, {"data": SHAPES[net]}, seed=4)
    _, jouts, _, jaux = _run("jax", jsym, args, aux, train=False)
    _, touts, _, taux = _run("port", tsym, args, aux, train=False)
    for g, w in zip(touts, jouts):
        _close(g, w)
    for k in jaux:  # predict mode leaves the moving statistics alone
        np.testing.assert_array_equal(taux[k], aux[k])


SOFTMAX_CASES = [
    ("null", {}),
    ("batch", {"normalization": "batch", "grad_scale": 2.0}),
    ("valid", {"normalization": "valid"}),
    ("valid-ignore", {"normalization": "valid", "use_ignore": True,
                      "ignore_label": 2}),
    ("ignore", {"use_ignore": True, "ignore_label": 0}),
    ("smooth", {"smooth_alpha": 0.1, "normalization": "batch"}),
    ("multi", {"multi_output": True, "normalization": "valid"}),
    ("multi-ignore", {"multi_output": True, "use_ignore": True,
                      "ignore_label": 1, "normalization": "valid"}),
]


@pytest.mark.parametrize("case", SOFTMAX_CASES,
                         ids=[c[0] for c in SOFTMAX_CASES])
def test_softmax_output_gradient_equals_jax(case):
    _, attrs = case
    multi = attrs.get("multi_output", False)
    shape = (3, 4, 5) if multi else (6, 4)
    label_shape = (3, 5) if multi else (6,)
    rng = np.random.RandomState(2)
    args = {"x": rng.randn(*shape).astype(np.float32),
            "y": rng.randint(0, 4, label_shape).astype(np.float32)}
    res = []
    for pkg in ("jax", "port"):
        mx = jmx if pkg == "jax" else tmx
        sym = mx.sym.SoftmaxOutput(mx.sym.Variable("x"), mx.sym.Variable("y"),
                                   name="sm", **attrs)
        res.append(_run(pkg, sym, args, {},
                        grad_req={"x": "write", "y": "null"}))
    (_, jouts, jgrads, _), (_, touts, tgrads, _) = res
    _close(touts[0], jouts[0])
    _close(tgrads["x"], jgrads["x"])
    assert "y" not in tgrads


@pytest.mark.parametrize("head", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput"])
def test_regression_heads_equal_jax(head):
    rng = np.random.RandomState(6)
    args = {"x": rng.randn(5, 3).astype(np.float32),
            "y": rng.randint(0, 2, (5, 3)).astype(np.float32)}
    res = []
    for pkg in ("jax", "port"):
        mx = jmx if pkg == "jax" else tmx
        sym = getattr(mx.sym, head)(mx.sym.Variable("x"),
                                    mx.sym.Variable("y"), grad_scale=3.0)
        res.append(_run(pkg, sym, args, {},
                        grad_req={"x": "write", "y": "null"}))
    (_, jouts, jgrads, _), (_, touts, tgrads, _) = res
    _close(touts[0], jouts[0])
    _close(tgrads["x"], jgrads["x"])


def test_grad_req_add_and_null():
    tsym = build("port", "mlp")
    args, aux = _values(tsym, {"data": SHAPES["mlp"]}, seed=3)
    reqs = {n: "add" for n in tsym.list_arguments()}
    reqs.update(data="null", softmax_label="null", fc3_bias="null")
    ex, _, once, _ = _run("port", tsym, args, aux, grad_req=reqs)
    assert sorted(ex.grad_dict) == ["fc1_bias", "fc1_weight", "fc2_bias",
                                    "fc2_weight", "fc3_weight"]
    ex.forward(is_train=True)
    ex.backward()
    for k, g in ex.grad_dict.items():
        _close(g.asnumpy(), 2 * once[k])


def test_outputs_before_backward_update_aux_once():
    """Reading the outputs of a train forward runs it (and moves the
    moving statistics); the backward after it leaves them as one update,
    as in the JAX package."""
    jsym, tsym = build("jax", "bn"), build("port", "bn")
    args, aux = _values(jsym, {"data": SHAPES["bn"]}, seed=8)
    ex_j, _, _, want = _run("jax", jsym, args, aux)
    ex = tsym.bind(CPU, {k: tmx.nd.array(v, ctx=CPU) for k, v in
                         args.items()},
                   aux_states={k: tmx.nd.array(v, ctx=CPU)
                               for k, v in aux.items()})
    ex.forward(is_train=True)
    first = ex.outputs[0].asnumpy()
    mid = {k: a.asnumpy() for k, a in ex.aux_dict.items()}
    ex.backward()
    for k in want:
        _close(mid[k], want[k])
        _close(ex.aux_dict[k].asnumpy(), want[k])
    np.testing.assert_array_equal(ex.outputs[0].asnumpy(), first)


def test_copy_params_reshape_and_errors():
    tsym = build("port", "mlp")
    ex = tsym.simple_bind(CPU, data=(4, 1, 28, 28))
    w = np.ones((32, 784), np.float32)
    ex.copy_params_from({"fc1_weight": tmx.nd.array(w, ctx=CPU)})
    np.testing.assert_array_equal(ex.arg_dict["fc1_weight"].asnumpy(), w)
    with pytest.raises(MXNetError, match="not in arguments"):
        ex.copy_params_from({"nope": tmx.nd.array(w, ctx=CPU)})
    ex.copy_params_from({"nope": tmx.nd.array(w, ctx=CPU)},
                        allow_extra_params=True)
    small = ex.reshape(data=(2, 1, 28, 28))
    assert small.arg_dict["data"].shape == (2, 1, 28, 28)
    assert small.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    assert small.arg_dict["softmax_label"].shape == (2,)
    with pytest.raises(MXNetError, match="requires forward"):
        small.backward()
    with pytest.raises(MXNetError, match="unknown argument"):
        ex.forward(nope=tmx.nd.array(w, ctx=CPU))


def test_fused_program_is_the_eager_one():
    """``backward`` on the CPU runs :meth:`Executor._fused_eager`, the
    program the card captures: the same gradients bit for bit."""
    tsym = build("port", "lenet")
    args, aux = _values(tsym, {"data": SHAPES["lenet"]}, seed=9)
    ex, _, grads, _ = _run("port", tsym, args, aux)
    ex.forward(is_train=True)
    ex._train_pending = False
    outs = ex._fused_eager([None])
    for k, g in ex.grad_dict.items():
        np.testing.assert_array_equal(g.asnumpy(), grads[k])
    assert isinstance(outs[0], torch.Tensor) and not outs[0].requires_grad


def test_train_forward_runs_the_graph_once(monkeypatch):
    """``forward(is_train=True)`` followed by ``backward`` evaluates the
    graph once (the JAX package's forward computes the outputs at once,
    so its training batch runs the forward twice): in the fused program,
    or, where the outputs are read before the backward, at the read,
    whose run the backward takes its gradients from, with the same
    values."""
    tsym = build("port", "bn")
    args, aux = _values(tsym, {"data": SHAPES["bn"]}, seed=10)
    _, want, grads, _ = _run("port", tsym, args, aux)
    calls = []
    real = tmx.executor.Executor._eval

    def counted(self, *a):
        calls.append(a[-1])
        return real(self, *a)

    monkeypatch.setattr(tmx.executor.Executor, "_eval", counted)
    for read_first in (False, True):
        ex, _, _, _ = _run("port", tsym, args, aux, train=False)
        del calls[:]
        outs = ex.forward(is_train=True)
        assert calls == [] and len(outs) == 1
        if read_first:
            np.testing.assert_array_equal(outs[0].asnumpy(), want[0])
        ex.backward()
        assert calls == [True]
        np.testing.assert_array_equal(outs[0].asnumpy(), want[0])
        for k, g in ex.grad_dict.items():
            np.testing.assert_array_equal(g.asnumpy(), grads[k])
    mod = tmx.mod.Module(tsym, label_names=["linearregressionoutput0_label"],
                         context=CPU)
    mod.bind([("data", SHAPES["bn"])],
             [("linearregressionoutput0_label", (2, 3))])
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=CPU)
                                for k, v in args.items()},
                    aux_params={k: tmx.nd.array(v, ctx=CPU)
                                for k, v in aux.items()},
                    allow_missing=True)
    del calls[:]
    mod.forward_backward(tmx.io.DataBatch(
        [tmx.nd.array(args["data"], ctx=CPU)],
        [tmx.nd.array(args["linearregressionoutput0_label"], ctx=CPU)]))
    assert calls == [True]
