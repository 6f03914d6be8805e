"""The port's op registry against the JAX package's: every name and alias,
the calling convention, and every op once on the same seeded inputs.

Tolerances: float32 results within 1e-6 relative (1e-5 for reductions and
products, whose sums run in another order); integer, boolean and index
results exactly; dtypes equal.  The random ops draw from other generators
in the two packages, so their laws are held instead of their draws.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import operator as joperator
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import test_utils as T
from mxnet_tpu_torch.ops import registry as treg

CPU = tmx.cpu()
# the JAX twin of the port's Custom case (the port registers its own)
T.register_case_op(joperator)
_LOOSE = {"sum", "mean", "prod", "nansum", "nanprod", "norm", "cumsum",
          "dot", "batch_dot", "FullyConnected", "Convolution", "LayerNorm",
          "BatchNorm", "softmax", "log_softmax", "RNN"}
# transcendental functions: the two libraries' implementations may differ
# by a few float32 ulps (2e-6 relative covers 16 ulps)
_ULPS = {"erfinv", "digamma", "gamma", "gammaln", "tan", "cbrt", "rcbrt",
         "_rpower_scalar", "_power_scalar", "elemwise_power",
         "broadcast_power", "arccosh", "arcsinh", "arctanh", "expm1",
         "LeakyReLU"}


def _tol(name):
    if name in _LOOSE:
        return 1e-5
    return 2e-6 if name in _ULPS else 1e-6


def _jax_outputs(case, arrays):
    name = T.op_name(case)
    op = jreg.get(name)
    attrs = op.canonicalize_attrs(T.OP_CASES[case][1])
    args = [jax.numpy.asarray(a) for a in arrays]
    if name in ("Dropout", "RNN"):  # outside training: no key
        args = [None] + args
    out = op.fn(*args, **attrs)
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


def _port_outputs(case, arrays):
    name = T.op_name(case)
    attrs = dict(T.OP_CASES[case][1])
    if name in T.NO_TENSOR_OPS:
        attrs["ctx"] = CPU
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    out = treg.apply_op(name, *tensors, **attrs)
    if name in T.INPLACE_OPS:  # the weights and the states, updated
        return [t.numpy() for t in T.updated(case, tensors)]
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def test_names_and_aliases_match_jax():
    jax_ops = set(jreg.list_ops())
    names = treg.list_ops()
    assert len(names) >= 180
    for n in names:
        assert n in jax_ops, n
        assert set(treg.get(n).aliases) == set(jreg.get(n).aliases), n


def test_calling_convention_matches_jax():
    """Positional scalars of mx.nd.<op> land on the same keyword in both
    packages: the port's keyword parameters start with the JAX op's."""
    def names(op, table):
        tensor = set(table.get(op.name, ()))
        return [p.name for p in inspect.signature(op.fn).parameters.values()
                if p.default is not inspect.Parameter.empty
                and p.name not in tensor]

    for n in treg.list_ops():
        want = names(jreg.get(n), jreg.OP_INPUT_NAMES)
        got = names(treg.get(n), treg.OP_INPUT_NAMES)
        assert got[:len(want)] == want, n


def test_every_op_has_a_case():
    assert {T.op_name(c) for c in T.OP_CASES} == set(treg.list_ops())


@pytest.mark.parametrize("case", sorted(c for c in T.OP_CASES
                                        if T.op_name(c) not in T.RANDOM_OPS))
def test_op_matches_jax(case):
    arrays = T.make_inputs(case, seed=7)
    want = _jax_outputs(case, arrays)
    got = _port_outputs(case, arrays)
    assert len(got) == len(want)
    op = treg.get(T.op_name(case))
    if op.name not in T.INPLACE_OPS:  # those return the weight alone
        assert op.nout(op.canonicalize_attrs(T.OP_CASES[case][1])) \
            == len(got)
    tol = _tol(T.op_name(case))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            scale = max(1.0, float(np.nanmax(np.abs(w), initial=0.0,
                                             where=np.isfinite(w))))
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(T.RANDOM_OPS))
def test_random_op_law(case):
    """Same shape and dtype as the JAX op's draws, values in range, and the
    moments of the law; shuffle is a permutation."""
    arrays = T.make_inputs(case, seed=7)
    attrs = T.OP_CASES[case][1]
    key = jax.random.PRNGKey(7)
    want = np.asarray(jreg.get(case).fn(
        key, *[jax.numpy.asarray(a) for a in arrays],
        **jreg.get(case).canonicalize_attrs(attrs)))
    tmx.random.seed(7)
    got = _port_outputs(case, arrays)[0]
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    if case == "_random_uniform":
        assert got.min() >= -1.0 and got.max() < 3.0
        assert abs(got.mean() - 1.0) < 0.1 and abs(got.std() - 4 / 12 ** .5) \
            < 0.1
    elif case == "_random_normal":
        assert abs(got.mean() - 1.0) < 0.15 and abs(got.std() - 2.0) < 0.15
    elif case == "_random_randint":
        assert set(np.unique(got)) == set(range(3, 9)) == set(np.unique(want))
    else:
        np.testing.assert_array_equal(np.sort(got, axis=0),
                                      np.sort(want, axis=0))
        assert not np.array_equal(got, arrays[0])


@pytest.mark.parametrize("shape,src", [
    ((0, -1), (2, 3, 4)), ((-1,), (2, 3, 4)), ((-2,), (2, 3, 4)),
    ((0, -2), (2, 3, 4)), ((-3, 4), (2, 3, 4)), ((2, -3), (2, 3, 4)),
    ((-4, 1, 2, -2), (2, 3, 4)), ((0, -4, -1, 3, 0), (2, 6, 4)),
    ((-4, 3, -1, 0), (6, 4)), ((4, 0, -1), (2, 3, 4))])
@pytest.mark.parametrize("reverse", [False, True])
def test_reshape_special_codes(shape, src, reverse):
    x = np.arange(np.prod(src), dtype=np.float32).reshape(src)
    try:
        want = np.asarray(jreg.get("Reshape").fn(jax.numpy.asarray(x),
                                                 shape=shape,
                                                 reverse=reverse))
    except (TypeError, ValueError, IndexError):
        with pytest.raises(tmx.MXNetError):
            tnd.Reshape(tnd.array(x, ctx=CPU), shape=shape, reverse=reverse)
        return
    got = tnd.Reshape(tnd.array(x, ctx=CPU), shape=shape, reverse=reverse)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want)


@pytest.mark.parametrize("value,want", [
    ("(2,2)", (2, 2)), ("(3,)", (3,)), ("()", ()), ("[1, 2]", (1, 2)),
    ("True", True), ("false", False), ("None", None), ("0.5", 0.5),
    ("-1", -1), ("relu", "relu"), ("float32", "float32"),
    (np.int64(3), 3), ([1, [2, 3]], (1, (2, 3)))])
def test_attr_canonicalisation(value, want):
    got = treg.canonical_attr(value)
    assert got == want and type(got) is type(want)


def test_string_attrs_reach_the_op():
    """MXNet's string attributes (as a symbol file or the C API give them)
    run the op as their parsed values do, in the port and in JAX."""
    x = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    a = tnd.array(x, ctx=CPU)
    pairs = [
        (tnd.Reshape(a, shape="(0, -1)"),
         jmx.nd.Reshape(jmx.nd.array(x), shape=(0, -1))),
        (tnd.sum(a, axis="(0, 2)", keepdims="True"),
         jmx.nd.sum(jmx.nd.array(x), axis=(0, 2), keepdims=True)),
        (tnd.LeakyReLU(a, act_type="leaky", slope="0.1"),
         jmx.nd.LeakyReLU(jmx.nd.array(x), act_type="leaky", slope=0.1)),
        (tnd.transpose(a, axes="(1, 0, 2)"),
         jmx.nd.transpose(jmx.nd.array(x), axes=(1, 0, 2))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6,
                                   atol=1e-6)


def test_register_rejects_a_second_op_under_one_name():
    with pytest.raises(tmx.MXNetError, match="already registered"):
        treg.register("sum")(lambda x, **_: x)
    with pytest.raises(tmx.MXNetError, match="not registered"):
        treg.alias("also_sum", "NoSuchOp")
    treg.alias("sum", "sum")  # the same op: a no-op
    with pytest.raises(tmx.MXNetError, match="not registered"):
        treg.get("BogusOp")


@pytest.mark.parametrize("name,shapes,attrs", [
    ("FullyConnected", ((2, 3, 4), (5, 12), (5,)), {"num_hidden": 5}),
    ("dot", ((4, 5), (3, 5)), {"transpose_b": True}),
    ("batch_dot", ((2, 4, 5), (2, 3, 5)), {"transpose_b": True}),
])
def test_mixed_dtype_products_promote_as_jax(name, shapes, attrs):
    """float16 data over float32 weights: both packages promote the
    operands (``jnp``'s rule, ``torch.promote_types``) and give float32,
    within 1e-5 of the JAX op (the same float32 products, summed in
    another order)."""
    rng = np.random.RandomState(3)
    arrays = [rng.randn(*s).astype(np.float16 if i == 0 else np.float32)
              for i, s in enumerate(shapes)]
    want = np.asarray(jreg.get(name).fn(*[jax.numpy.asarray(a)
                                          for a in arrays], **attrs))
    got = treg.apply_op(name, *[torch.from_numpy(a) for a in arrays],
                        **attrs).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mixed_dtype_convolution_raises_in_both_packages():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 6, 6).astype(np.float16)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    with pytest.raises(Exception):
        jreg.get("Convolution").fn(jax.numpy.asarray(x), jax.numpy.asarray(w),
                                   kernel=(3, 3), num_filter=4)
    with pytest.raises(Exception):
        treg.apply_op("Convolution", torch.from_numpy(x), torch.from_numpy(w),
                      kernel=(3, 3), num_filter=4)


def test_flash_attention_op_takes_a_symbol_files_strings_views_and_meta():
    """``_contrib_flash_attention`` as a symbol file hands it: string
    attributes (``"True"``, ``"None"``), strided views of a transposed
    qkv; on meta tensors the output's shape, no kernel; its gradients
    through the backward (the plain versions on the CPU) against JAX's
    autograd of the JAX op."""
    from mxnet_tpu_torch.ops import attention

    rng = np.random.RandomState(3)
    qkv = rng.randn(2, 7, 3 * 2, 8).astype(np.float32)   # (B, S, 3H, d)
    heads = torch.from_numpy(qkv).permute(0, 2, 1, 3)     # (B, 3H, S, d)
    q, k, v = (heads[:, i * 2:(i + 1) * 2] for i in range(3))
    assert not q.is_contiguous()
    fn = treg.get("_contrib_flash_attention").fn
    got = fn(q, k, v, causal="True", sm_scale="None")
    jq, jk, jv = (jax.numpy.asarray(np.ascontiguousarray(t.numpy()))
                  for t in (q, k, v))
    want = np.asarray(jreg.get("_contrib_flash_attention").fn(
        jq, jk, jv, causal=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, fn(q, k, v, causal=True, sm_scale=None))
    assert not torch.equal(got, fn(q, k, v, causal="False"))
    before = attention.flash_attention.launches
    meta = fn(*(torch.empty(2, 3, 5, 8, device="meta") for _ in range(3)),
              causal="True")
    assert meta.device.type == "meta" and meta.shape == (2, 3, 5, 8)
    assert attention.flash_attention.launches == before
    # gradients of sum(out * w) in both packages
    w = rng.randn(*want.shape).astype(np.float32)
    leaves = [t.contiguous().requires_grad_() for t in (q, k, v)]
    (fn(*leaves, causal=True) * torch.from_numpy(w)).sum().backward()
    jgrads = jax.grad(lambda a, b, c: (jreg.get(
        "_contrib_flash_attention").fn(a, b, c, causal=True) * w).sum(),
        argnums=(0, 1, 2))(jq, jk, jv)
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


def test_arange_like_pad_and_sync_batch_norm_through_a_symbol_file():
    """The new ops as nodes of a graph that crosses from the JAX package:
    its JSON's string attributes reach each op, and the port's executor
    gives the JAX executor's outputs (1e-6 of the magnitude)."""
    from mxnet_tpu.base import NameManager as JaxNameManager

    with JaxNameManager():
        data = jmx.sym.var("data")
        pos = jmx.sym.arange_like(data, axis=1, start=2.0, step=0.5)
        padded = jmx.sym.Pad(data, mode="edge",
                             pad_width=(0, 0, 0, 0, 1, 2, 0, 1))
        sbn = jmx.sym.SyncBatchNorm(
            data, jmx.sym.var("g"), jmx.sym.var("b"), jmx.sym.var("m"),
            jmx.sym.var("v"), fix_gamma=False, eps=1e-3)
        graph = jmx.sym.Group([pos, padded, sbn])
    rng = np.random.RandomState(5)
    arrays = {"data": rng.randn(2, 3, 4, 5), "g": rng.randn(3),
              "b": rng.randn(3), "m": rng.randn(3),
              "v": rng.uniform(0.5, 2.0, 3)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    want = [o.asnumpy() for o in graph.bind(
        jmx.cpu(), {k: jmx.nd.array(v) for k, v in arrays.items()})
        .forward()]
    port = tmx.sym.load_json(graph.tojson())
    got = [o.asnumpy() for o in port.bind(
        CPU, {k: tmx.nd.array(v, ctx=CPU) for k, v in arrays.items()})
        .forward()]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("name", ["sign", "sigmoid", "rsqrt", "softmax",
                                  "log_softmax", "negative", "elemwise_sub"])
def test_bool_operands_raise_where_the_jax_ops_raise(name):
    """The JAX ops refuse bool data here (``sign``, ``logistic``,
    ``rsqrt``, ``neg`` and ``sub`` do not accept it); so do the port's,
    with MXNetError in both packages."""
    a = np.array([[True, False, True], [False, True, True]])
    args = [a] * (2 if name == "elemwise_sub" else 1)
    with pytest.raises(jmx.base.MXNetError):
        jmx.nd.imperative_invoke(name, [jmx.nd.array(x, dtype=bool)
                                        for x in args], {})
    with pytest.raises(tmx.MXNetError, match="bool|Bool"):
        tnd.imperative_invoke(name, [tnd.array(x, dtype=bool, ctx=CPU)
                                     for x in args], {})
