"""MXNet's test API, and small seeded cases of every registered op.

The test API is the JAX package's (``mxnet_tpu/test_utils.py``; reference:
python/mxnet/test_utils.py), on the port's arrays and executors: the
default context (:func:`default_context`, :func:`set_default_context`,
through the port's context scopes: ``gpu(0)`` outside any scope),
:func:`default_dtype`, the seeded shapes and arrays (``rand_shape_*``,
:func:`rand_ndarray`, :func:`random_arrays`, from one
``RandomState(1234)`` as in the JAX package), the comparisons
(:func:`same`, :func:`almost_equal`, :func:`assert_almost_equal`,
:func:`find_max_violation`), the symbol checks (:func:`simple_forward`,
:func:`check_symbolic_forward`, :func:`check_symbolic_backward`,
:func:`check_numeric_gradient`, :func:`check_consistency`,
:func:`check_op_consistency`: each registered op imperatively, through an
executor and, where a card is present, on the card), :class:`DummyIter`,
:func:`get_mnist` and :func:`get_mnist_iterator` (the synthetic
``MNISTIter``, no download) and :func:`download`, which raises.

Counterpart, for the port, of ``mxnet_tpu/test_utils.py``'s role: the
CPU tests hold each op against the JAX package's op of the same name, and
``chip_smoke.py`` holds each op on the card against the same call on the
CPU, both from :data:`OP_CASES` and :func:`make_inputs`.

A case is ``(inputs, attrs)``.  Each input is a spec turned into a numpy
array by :func:`make_inputs` from ``numpy.random.RandomState(seed)``:

- ``("f", shape)``: float32 normal samples;
- ``("u", shape, lo, hi)``: float32 uniform samples in ``[lo, hi)``;
- ``("i", shape, lo, hi)``: int32 integers in ``[lo, hi)``;
- ``("fi", shape, lo, hi)``: the same integers as float32 (ties, indices);
- ``("v", values)`` or ``("v", values, dtype)``: the values themselves.

A key ``"op/extra"`` is one more case of ``op`` (``"sum/int32"``).  :data:`RANDOM_OPS` draw from a generator, so only
their laws can be compared; :data:`INPLACE_OPS` update their weight and
state inputs in place and return the weight (:func:`updated` lists
them).
"""

from __future__ import annotations

import contextlib

import numpy as np

__all__ = ["OP_CASES", "RANDOM_OPS", "INPLACE_OPS", "NO_TENSOR_OPS",
           "CUSTOM_CASE", "make_inputs", "op_name", "register_case_op",
           "updated", "default_context", "set_default_context",
           "default_dtype", "rand_shape_2d", "rand_shape_3d",
           "rand_shape_nd", "rand_ndarray", "random_arrays",
           "find_max_violation", "assert_almost_equal", "almost_equal",
           "same", "check_numeric_gradient", "check_symbolic_forward",
           "check_symbolic_backward", "check_consistency",
           "check_op_consistency", "simple_forward", "DummyIter",
           "get_mnist", "get_mnist_iterator", "download"]

_F = ("f", (3, 4))
_HALVES = ("v", [[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.3, -0.7]])
_SPECIAL = ("v", [[0.0, 1.0, float("nan"), float("inf")],
                  [-float("inf"), -2.0, 3.5, float("nan")]])
_UNIT = ("u", (3, 4), -0.9, 0.9)
_POS = ("u", (3, 4), 0.2, 3.0)
_VAR = ("u", (3, 4), 0.1, 1.0)  # a positive optimizer state

_UNARY_INPUT = {
    "sqrt": _POS, "rsqrt": _POS, "log": _POS, "log10": _POS, "log2": _POS,
    "log1p": _POS, "gamma": _POS, "gammaln": _POS, "digamma": _POS,
    "reciprocal": _POS, "rcbrt": _POS, "arcsin": _UNIT, "arccos": _UNIT,
    "arctanh": _UNIT, "erfinv": _UNIT, "arccosh": ("u", (3, 4), 1.1, 4.0),
    "round": _HALVES, "rint": _HALVES, "isnan": _SPECIAL, "isinf": _SPECIAL,
    "isfinite": _SPECIAL, "logical_not": ("fi", (3, 4), 0, 2),
    "abs": ("i", (3, 4), -5, 5),
}
_UNARY = ("abs sign rint ceil floor trunc fix round square sqrt rsqrt cbrt "
          "rcbrt exp expm1 log log10 log2 log1p sin cos tan arcsin arccos "
          "arctan sinh cosh tanh arcsinh arccosh arctanh degrees radians "
          "sigmoid softsign relu erf erfinv gamma gammaln digamma reciprocal "
          "negative logical_not isnan isinf isfinite").split()
_BINARY = ("add sub mul div mod power maximum minimum hypot equal not_equal "
           "greater greater_equal lesser lesser_equal logical_and logical_or "
           "logical_xor").split()
_BINARY_INPUTS = {
    "div": (_F, ("u", (3, 4), 0.5, 2.0)),
    "mod": (("f", (3, 4)), ("v", [[1.5, -1.5, 0.7, -0.7]] * 3)),
    "power": (_POS, _F),
}
_CMP = {"equal", "not_equal", "greater", "greater_equal", "lesser",
        "lesser_equal", "logical_and", "logical_or", "logical_xor"}
_SCALAR = ("plus minus rminus mul div rdiv mod rmod power rpower maximum "
           "minimum hypot equal not_equal greater greater_equal lesser "
           "lesser_equal logical_and logical_or logical_xor").split()
_SCALAR_INPUT = {"rdiv": _POS, "rmod": ("u", (3, 4), 0.5, 2.0),
                 "power": _POS, "rpower": _F,
                 "equal": ("fi", (3, 4), 0, 4),
                 "not_equal": ("fi", (3, 4), 0, 4),
                 "greater_equal": ("fi", (3, 4), 0, 4),
                 "lesser_equal": ("fi", (3, 4), 0, 4),
                 "logical_and": ("fi", (3, 4), 0, 2),
                 "logical_or": ("fi", (3, 4), 0, 2),
                 "logical_xor": ("fi", (3, 4), 0, 2)}
_SCALAR_VALUE = {"mod": -1.5, "rmod": 1.5, "power": 2.5, "rpower": 1.5,
                 "equal": 2.0, "not_equal": 2.0, "greater_equal": 2.0,
                 "lesser_equal": 2.0, "logical_and": 1.0,
                 "logical_or": 0.0, "logical_xor": 1.0}

_X345 = ("f", (3, 4, 5))


def _detection_arrays():
    """Fixed boxes for the detection ops: corner anchors (1, 24, 4),
    labels (2, 3, 5) with a padding row, class logits (2, 4, 24), box
    offsets (2, 96), and NMS rows (2, 12, 6) [id, score, box] around
    three centres, so that boxes overlap and classes repeat."""
    rng = np.random.RandomState(11)
    xy = rng.uniform(0.0, 0.7, (24, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(0.1, 0.3, (24, 2))], 1)
    labels = np.array([[[1, .1, .1, .4, .5], [2, .5, .45, .9, .8],
                        [0, .3, .6, .6, .95]],
                       [[2, .2, .3, .5, .6], [0, .6, .1, .9, .3],
                        [-1, -1, -1, -1, -1]]])
    centres = rng.uniform(0.3, 0.7, (3, 2))[rng.randint(0, 3, (2, 12))]
    half = rng.uniform(0.1, 0.2, (2, 12, 2))
    rows = np.concatenate([rng.randint(0, 3, (2, 12, 1)),
                           rng.uniform(0.0, 1.0, (2, 12, 1)),
                           centres - half, centres + half], -1)
    f32 = [np.float32(a) for a in (anchors[None], labels,
                                  rng.randn(2, 4, 24), rng.randn(2, 96) * .5,
                                  rows)]
    return [("v", a) for a in f32]


_ANCHORS, _LABELS, _CLS_PRED, _LOC_PRED, _NMS_ROWS = _detection_arrays()
_CLS_PROB = ("v", np.float32(np.exp(_CLS_PRED[1])
                             / np.exp(_CLS_PRED[1]).sum(1, keepdims=True)))
_CENTER_BOXES = ("v", np.float32(np.concatenate(
    [_NMS_ROWS[1][0, :5, 2:4] + _NMS_ROWS[1][0, :5, 4:6],
     _NMS_ROWS[1][0, :5, 4:6] - _NMS_ROWS[1][0, :5, 2:4]], 1) / [2, 2, 1, 1]))
_NANS = ("v", [[0.5, 1.0, float("nan"), 2.0],
               [-1.0, float("nan"), 3.5, 0.25]])
_ROWS = ("fi", (3, 6), 0, 3)  # ties in every row
_BOOLS = ("v", [[True, False, True, True], [False, False, True, False],
                [True, True, False, True]], "bool")
_BOOL_ROW = ("v", [[True, False, True, False]], "bool")

OP_CASES = {}
for _n in _UNARY:
    OP_CASES[_n] = ([_UNARY_INPUT.get(_n, _F)], {})
for _n in _BINARY:
    _ins = _BINARY_INPUTS.get(_n)
    if _ins is None:
        _ins = (("fi", (3, 4), 0, 3),) * 2 if _n in _CMP else (_F, _F)
    OP_CASES["elemwise_" + _n] = (list(_ins), {})
    OP_CASES["broadcast_" + _n] = ([_ins[0], (_ins[1][0], (1, 4))
                                    + tuple(_ins[1][2:])]
                                   if _ins[1][0] != "v"
                                   else [_ins[0], ("v", _ins[1][1][:1])], {})
for _n in _SCALAR:
    OP_CASES["_%s_scalar" % _n] = ([_SCALAR_INPUT.get(_n, _F)],
                                   {"scalar": _SCALAR_VALUE.get(_n, 0.75)})
OP_CASES.update({
    # element-wise, the rest of the module
    "softrelu": ([_F], {}),
    "hard_sigmoid": ([("f", (3, 4))], {"alpha": 0.3, "beta": 0.4}),
    "clip": ([_F], {"a_min": -0.5, "a_max": 0.5}),
    "Cast": ([("v", [[-1.7, -0.5, 0.5, 2.9]])], {"dtype": "int32"}),
    "_copy": ([_F], {}),
    "BlockGrad": ([_F], {}),
    "make_loss": ([_F], {}),
    "_scatter_elemwise_div": ([_F, ("u", (3, 4), 0.5, 2.0)], {}),
    "smooth_l1": ([("f", (3, 4))], {"scalar": 2.0}),
    "add_n": ([_F, _F, _F], {}),
    "where": ([("fi", (3,), 0, 2), _F, _F], {}),
    "_plus_scalar/int32": ([("i", (3, 4), -5, 5)], {"scalar": 2.5}),
    "elemwise_mul/int32": ([("i", (3, 4), -5, 5), ("i", (3, 4), -5, 5)], {}),
    # integers past their range, NaN, the infinities, zeros and divisors
    # of 0, where the two devices (and the two packages) could part
    "_mul_scalar/uint8-wraps": ([("v", [[200, 0, 7, 255]], "uint8")],
                                {"scalar": 3}),
    "_minus_scalar/int8-wraps": ([("v", [[100, -128, 0, 5]], "int8")],
                                 {"scalar": 3}),
    "_rpower_scalar/int32": ([("v", [[5, -7, 0, 70]], "int32")],
                             {"scalar": 3}),
    "_mod_scalar/int32-by-0": ([("i", (3, 4), -5, 5)], {"scalar": 0}),
    "_rmod_scalar/int32-at-0": ([("v", [[5, -7, 0, 3]], "int32")],
                                {"scalar": 3}),
    "broadcast_mod/int32-by-0": ([("i", (3, 4), -9, 9),
                                  ("v", [[0, 3, 0, -2]], "int32")], {}),
    "elemwise_power/int8": ([("i", (3, 4), -3, 4), ("i", (3, 4), -9, 70)],
                            {}),
    "Cast/int8-saturates": ([("v", [[300.7, -1.5, float("nan"),
                                     float("inf")],
                                    [-float("inf"), 127.9, -128.9, 0.5]])],
                            {"dtype": "int8"}),
    "Cast/int32-saturates": ([("v", [[1e10, -3e9, float("nan"),
                                      -float("inf")]])], {"dtype": "int32"}),
    "Cast/uint8-saturates": ([("v", [[-1.5, 255.5, float("nan"),
                                      float("inf")]])], {"dtype": "uint8"}),
    "sign/nan-and-zeros": ([("v", [[float("nan"), -0.0, 0.0, -2.5],
                                   [3.0, -float("inf"), float("inf"),
                                    -1e-30]])], {}),
    "rint/int32": ([("i", (3, 4), -5, 5)], {}),
    # bool operands take the JAX ops' result types
    "abs/bool": ([_BOOLS], {}),
    "ceil/bool": ([_BOOLS], {}),
    "floor/bool": ([_BOOLS], {}),
    "trunc/bool": ([_BOOLS], {}),
    "fix/bool": ([_BOOLS], {}),
    "relu/bool": ([_BOOLS], {}),
    "square/bool": ([_BOOLS], {}),
    "clip/bool": ([_BOOLS], {"a_min": 0, "a_max": 1}),
    "smooth_l1/bool": ([_BOOLS], {"scalar": 1.0}),
    "Activation/bool-relu": ([_BOOLS], {"act_type": "relu"}),
    "argmax/bool": ([_BOOLS], {"axis": 0}),
    "argmin/bool": ([_BOOLS], {"axis": 1}),
    "dot/bool": ([_BOOLS, _BOOLS], {"transpose_b": True}),
    "batch_dot/bool": ([("v", [[[True, False, True], [False, False, True]]],
                         "bool"),
                        ("v", [[[True, False], [False, True], [False, True]]],
                         "bool")], {}),
    "FullyConnected/bool": ([_BOOLS, ("v", [[True, False, False, True],
                                            [False, False, False, False]],
                                           "bool")],
                            {"num_hidden": 2, "no_bias": True}),
    "broadcast_power/bool": ([_BOOLS, _BOOL_ROW], {}),
    "broadcast_mod/bool": ([_BOOLS, _BOOL_ROW], {}),
    "_minus_scalar/bool": ([_BOOLS], {"scalar": 3.0}),
    "_rminus_scalar/bool": ([_BOOLS], {"scalar": 3.0}),
    "_plus_scalar/bool-int": ([_BOOLS], {"scalar": 2}),
    # reductions
    "sum": ([_X345], {"axis": (0, 2)}),
    "sum/int32": ([("i", (3, 4, 5), -9, 9)], {"axis": 1}),
    "mean": ([_X345], {"axis": 1, "keepdims": True}),
    "mean/int32": ([("i", (3, 4, 5), -9, 9)], {}),
    "prod": ([("u", (3, 4, 5), 0.5, 1.5)], {"axis": 1}),
    "max": ([_X345], {"axis": 1, "exclude": True}),
    "min": ([_X345], {}),
    "nansum": ([_NANS], {"axis": 1}),
    "nanprod": ([_NANS], {"axis": 1}),
    "norm": ([_X345], {"ord": 1, "axis": 1}),
    "norm/l2": ([_X345], {"axis": (0, 2), "keepdims": True}),
    "argmax": ([_ROWS], {"axis": 1}),
    "argmin": ([_ROWS], {"keepdims": True}),
    "argmax_channel": ([("f", (2, 3, 4))], {}),
    "broadcast_to": ([("f", (1, 4))], {"shape": (3, 0)}),
    "broadcast_axis": ([("f", (3, 1, 5))], {"axis": 1, "size": 4}),
    "broadcast_like": ([("f", (1, 4)), ("f", (3, 4))], {}),
    "cumsum": ([_X345], {"axis": 1}),
    "cumsum/int32": ([("i", (3, 4), -5, 5)], {}),
    "cumsum/int8-wraps": ([("v", [[100, 100, -128, 5]], "int8")],
                          {"axis": 1}),
    "sum/uint8": ([("v", [[200, 255, 7], [0, 1, 255]], "uint8")], {}),
    "prod/int32-wraps": ([("v", [[70000, 70000, 3], [-2, 5, 0]], "int32")],
                         {"axis": 1}),
    "prod/uint8": ([("v", [[255] * 5, [3, 0, 1, 2, 9]], "uint8")],
                   {"axis": 1}),
    "nansum/int8": ([("v", [[100, 100, -128, 5]], "int8")], {}),
    "nanprod/uint8": ([("v", [[255] * 5], "uint8")], {}),
    "norm/int8-l1": ([("v", [[100, -128, 5], [7, -1, 0]], "int8")],
                     {"ord": 1, "axis": 1}),
    # creation
    "_zeros": ([], {"shape": (2, 3)}),
    "_ones": ([], {"shape": (2, 3), "dtype": "int32"}),
    "_full": ([], {"shape": (2, 3), "value": 7.5}),
    "zeros_like": ([("i", (2, 3), 0, 9)], {}),
    "ones_like": ([_F], {}),
    "_arange": ([], {"start": 2, "stop": 11, "step": 1.5, "repeat": 2}),
    "_linspace": ([], {"start": -1.0, "stop": 2.0, "num": 7,
                       "endpoint": False}),
    "_eye": ([], {"N": 4, "M": 5, "k": 1}),
    "_random_uniform": ([], {"low": -1.0, "high": 3.0, "shape": (4000,)}),
    "_random_normal": ([], {"loc": 1.0, "scale": 2.0, "shape": (4000,)}),
    "_random_randint": ([], {"low": 3, "high": 9, "shape": (4000,)}),
    "_shuffle": ([("v", np.arange(24.0).reshape(12, 2))], {}),
    # shape, products, ordering, indexing
    "Reshape": ([("f", (2, 3, 4))], {"shape": (0, -1)}),
    "reshape_like": ([("f", (2, 6)), ("f", (3, 4))], {}),
    "Flatten": ([("f", (2, 3, 4))], {}),
    "transpose": ([("f", (2, 3, 4))], {"axes": (2, 0, 1)}),
    "SwapAxis": ([("f", (2, 3, 4))], {"dim1": 0, "dim2": 2}),
    "expand_dims": ([_F], {"axis": 1}),
    "squeeze": ([("f", (2, 1, 3, 1))], {}),
    "Concat": ([_F, ("f", (3, 2))], {"dim": 1}),
    "stack": ([_F, _F], {"axis": 1}),
    "SliceChannel": ([("f", (4, 6))], {"num_outputs": 3, "axis": 1}),
    "slice": ([("f", (4, 6))], {"begin": (1, None), "end": (3, 5),
                                "step": (1, 2)}),
    "slice/negative-step": ([("f", (4, 6))], {"begin": (None, 5),
                                              "end": (None, 0),
                                              "step": (1, -2)}),
    "slice_axis": ([("f", (4, 6))], {"axis": 1, "begin": 1, "end": -1}),
    "tile": ([_F], {"reps": (2, 1)}),
    "repeat": ([_F], {"repeats": 2, "axis": 0}),
    "reverse": ([_F], {"axis": 1}),
    "dot": ([("f", (4, 5)), ("f", (3, 5))], {"transpose_b": True}),
    "dot/3d": ([("f", (2, 3, 4)), ("f", (4, 5))], {}),
    "batch_dot": ([("f", (2, 4, 5)), ("f", (2, 3, 5))],
                  {"transpose_b": True}),
    "take": ([("f", (5, 3)), ("v", [0.0, 2.7, -1.0, 7.0])], {}),
    "take/wrap": ([("f", (5, 3)), ("v", [[0, 6], [-1, 3]], "int32")],
                  {"axis": 0, "mode": "wrap"}),
    "one_hot": ([("v", [0.0, 2.0, 5.0, -1.0, 3.9])], {"depth": 4,
                                                       "on_value": 2.0,
                                                       "off_value": -1.0}),
    "pick": ([_F, ("v", [0.0, 3.0, 5.0])], {"axis": 1}),
    "sort": ([_ROWS], {"axis": 1, "is_ascend": False}),
    "argsort": ([_ROWS], {"axis": 1}),
    "argsort/descending": ([_ROWS], {"axis": 1, "is_ascend": False}),
    "topk": ([_ROWS], {"axis": 1, "k": 3, "ret_typ": "both"}),
    "topk/mask": ([_ROWS], {"axis": 1, "k": 2, "ret_typ": "mask",
                            "is_ascend": True}),
    "_basic_index": ([("f", (4, 5, 6))], {"key": (("i", 1), ("s", None, None,
                                                            2), ("n",),
                                                   ("s", 1, 5, None))}),
    "Embedding": ([("fi", (2, 3), 0, 6), ("f", (6, 4))],
                  {"input_dim": 6, "output_dim": 4}),
    # neural-network ops
    "FullyConnected": ([("f", (2, 3, 4)), ("f", (5, 12)), ("f", (5,))],
                       {"num_hidden": 5}),
    "Activation": ([_F], {"act_type": "sigmoid"}),
    "LeakyReLU": ([_F], {"act_type": "elu", "slope": 0.3}),
    "LeakyReLU/gelu": ([_F], {"act_type": "gelu"}),
    "LayerNorm": ([("f", (2, 3, 8)), ("f", (8,)), ("f", (8,))], {}),
    "Dropout": ([_F], {"p": 0.5}),
    "softmax": ([("f", (3, 5))], {"axis": 1, "temperature": 2.0}),
    "log_softmax": ([("f", (3, 5))], {"axis": 0}),
    "log_softmax/int32": ([("i", (3, 5), -6, 6)], {"axis": -1}),
    "softmax/int32": ([("i", (3, 5), -6, 6)], {"axis": 0}),
    "Convolution": ([("f", (2, 6, 6, 3)), ("f", (4, 3, 3, 3)), ("f", (4,))],
                    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                     "num_filter": 4, "layout": "NHWC"}),
    "Pooling": ([("f", (2, 6, 6, 3))], {"kernel": (3, 3), "stride": (2, 2),
                                        "pad": (1, 1), "pool_type": "max",
                                        "layout": "NHWC"}),
    "Pooling/lp": ([("f", (2, 7, 7, 3))], {"kernel": (3, 3),
                                           "stride": (2, 2), "pad": (1, 1),
                                           "pool_type": "lp", "p_value": 3,
                                           "layout": "NHWC"}),
    # the registered ops' default layout (NCHW data, OIHW weights)
    "Convolution/nchw": ([("f", (2, 3, 7, 7)), ("f", (4, 3, 3, 3)),
                          ("f", (4,))],
                         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                          "num_filter": 4}),
    "Convolution/nchw-1ch": ([("f", (2, 1, 8, 8)), ("f", (5, 1, 5, 5))],
                             {"kernel": (5, 5), "num_filter": 5,
                              "no_bias": True, "layout": "NCHW"}),
    "Pooling/nchw": ([("f", (2, 3, 8, 8))], {"kernel": (2, 2),
                                             "stride": (2, 2),
                                             "pool_type": "max"}),
    "Pooling/nchw-avg-full": ([("f", (2, 3, 7, 7))],
                              {"kernel": (3, 3), "stride": (2, 2),
                               "pool_type": "avg", "layout": "NCHW",
                               "pooling_convention": "full"}),
    # the Module API's loss heads (forward: softmax, identity, sigmoid)
    "SoftmaxOutput": ([("f", (4, 5)), ("fi", (4,), 0, 5)], {}),
    "SoftmaxOutput/multi": ([("f", (2, 3, 4)), ("fi", (2, 4), 0, 3)],
                            {"multi_output": True}),
    "LinearRegressionOutput": ([_F, _F], {}),
    "MAERegressionOutput": ([_F, _F], {"grad_scale": 2.0}),
    "LogisticRegressionOutput": ([_F, ("fi", (3, 4), 0, 2)], {}),
    "BatchNorm": ([("f", (2, 3, 4, 5)), ("f", (3,)), ("f", (3,)),
                   ("f", (3,)), ("u", (3,), 0.5, 2.0)],
                  {"fix_gamma": False, "output_mean_var": True}),
    # channel-last, the axis the card's kernels (K6a) take
    "BatchNorm/nhwc": ([("f", (2, 4, 5, 3)), ("f", (3,)), ("f", (3,)),
                        ("f", (3,)), ("u", (3,), 0.5, 2.0)],
                       {"fix_gamma": False, "axis": -1}),
    # channel-first data with a channel axis of 1, as SSD's NCHW layers
    "BatchNorm/nchw-global": ([("f", (2, 3, 4, 5)), ("f", (3,)),
                               ("f", (3,)), ("f", (3,)),
                               ("u", (3,), 0.5, 2.0)],
                              {"use_global_stats": True, "axis": 1}),
    "Convolution/nchw-dilated": ([("f", (2, 3, 11, 11)), ("f", (4, 3, 3, 3)),
                                  ("f", (4,))],
                                 {"kernel": (3, 3), "pad": (2, 2),
                                  "dilate": (2, 2), "num_filter": 4}),
    "Convolution/nhwc-dilated": ([("f", (2, 13, 13, 3)),
                                  ("f", (4, 3, 3, 3))],
                                 {"kernel": (3, 3), "pad": (6, 6),
                                  "dilate": (6, 6), "num_filter": 4,
                                  "no_bias": True, "layout": "NHWC"}),
    # groups (a depthwise one), 1-D and 3-D convolutions, both layouts
    "Convolution/nchw-grouped": ([("f", (2, 6, 7, 7)), ("f", (4, 3, 3, 3)),
                                  ("f", (4,))],
                                 {"kernel": (3, 3), "pad": (1, 1),
                                  "num_filter": 4, "num_group": 2}),
    "Convolution/nhwc-depthwise": ([("f", (2, 8, 8, 4)),
                                    ("f", (4, 3, 3, 1))],
                                   {"kernel": (3, 3), "stride": (2, 2),
                                    "pad": (1, 1), "num_filter": 4,
                                    "num_group": 4, "no_bias": True,
                                    "layout": "NHWC"}),
    "Convolution/ncw": ([("f", (2, 3, 11)), ("f", (4, 3, 3)), ("f", (4,))],
                        {"kernel": (3,), "stride": (2,), "pad": (1,),
                         "num_filter": 4}),
    "Convolution/nwc": ([("f", (2, 11, 6)), ("f", (4, 3, 3))],
                        {"kernel": (3,), "dilate": (2,), "num_filter": 4,
                         "num_group": 2, "no_bias": True, "layout": "NWC"}),
    "Convolution/ncdhw": ([("f", (2, 3, 5, 6, 6)), ("f", (4, 3, 3, 3, 3)),
                           ("f", (4,))],
                          {"kernel": (3, 3, 3), "pad": (1, 1, 1),
                           "stride": (1, 2, 2), "num_filter": 4}),
    "Convolution/ndhwc": ([("f", (2, 4, 5, 5, 4)), ("f", (4, 2, 3, 3, 2))],
                          {"kernel": (2, 3, 3), "num_filter": 4,
                           "num_group": 2, "no_bias": True,
                           "layout": "NDHWC"}),
    # transposed convolutions: adj, groups, a bias under no_bias=True
    "Deconvolution": ([("f", (2, 4, 5, 5)), ("f", (4, 3, 4, 4)),
                       ("f", (6,))],
                      {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
                       "adj": (1, 1), "num_filter": 6, "num_group": 2}),
    "Deconvolution/ncw": ([("f", (2, 3, 7)), ("f", (3, 2, 3))],
                          {"kernel": (3,), "stride": (2,), "num_filter": 2}),
    "Deconvolution/ncdhw": ([("f", (2, 2, 3, 3, 3)),
                             ("f", (2, 3, 3, 3, 3))],
                            {"kernel": (3, 3, 3), "stride": (2, 2, 2),
                             "pad": (1, 1, 1), "num_filter": 3}),
    # 1-D and 3-D pooling
    "Pooling/ncw": ([("f", (2, 3, 9))], {"kernel": (3,), "stride": (2,),
                                         "pad": (1,), "pool_type": "max"}),
    "Pooling/nwc-avg-full": ([("f", (2, 9, 3))],
                             {"kernel": (3,), "stride": (2,),
                              "pool_type": "avg", "layout": "NWC",
                              "pooling_convention": "full"}),
    "Pooling/ncdhw": ([("f", (2, 3, 5, 6, 6))],
                      {"kernel": (2, 2, 2), "stride": (2, 2, 2),
                       "pool_type": "max", "pooling_convention": "full"}),
    "Pooling/ndhwc-avg": ([("f", (2, 5, 6, 6, 3))],
                          {"kernel": (3, 3, 3), "stride": (2, 2, 2),
                           "pad": (1, 1, 1), "pool_type": "avg",
                           "count_include_pad": False, "layout": "NDHWC"}),
    "InstanceNorm": ([("f", (2, 3, 4, 5)), ("f", (3,)), ("f", (3,))],
                     {"eps": 1e-5}),
    "L2Normalization": ([("f", (2, 3, 4, 5))], {"mode": "channel"}),
    "L2Normalization/instance": ([("f", (2, 3, 4))], {}),
    "L2Normalization/spatial": ([("f", (2, 3, 4, 5))],
                                {"mode": "spatial", "eps": 1e-3}),
    # the detection ops (ops/contrib.py)
    "box_iou": ([_ANCHORS, ("v", _LABELS[1][:, :, 1:])], {}),
    "box_iou/center": ([_CENTER_BOXES, _CENTER_BOXES], {"format": "center"}),
    "box_nms": ([_NMS_ROWS], {"overlap_thresh": 0.3, "valid_thresh": 0.1,
                              "id_index": 0, "topk": 9}),
    "box_nms/force": ([_NMS_ROWS], {"overlap_thresh": 0.3, "id_index": 0,
                                    "force_suppress": True}),
    "MultiBoxPrior": ([("f", (1, 2, 4, 5))],
                      {"sizes": (0.3, 0.5), "ratios": (1.0, 2.0, 0.5),
                       "steps": (0.2, 0.25), "clip": True}),
    "MultiBoxTarget": ([_ANCHORS, _LABELS, _CLS_PRED],
                       {"negative_mining_ratio": 3.0}),
    "MultiBoxTarget/no-mining": ([_ANCHORS, _LABELS, _CLS_PRED],
                                 {"overlap_threshold": 0.3}),
    "MultiBoxDetection": ([_CLS_PROB, _LOC_PRED, _ANCHORS],
                          {"nms_threshold": 0.45, "threshold": 0.2}),
    # the recurrent op: packed cuDNN-layout parameters, (T, N, C) data
    "RNN": ([("f", (5, 3, 4)), ("u", (624,), -0.5, 0.5), ("f", (2, 3, 6)),
             ("f", (2, 3, 6))],
            {"state_size": 6, "num_layers": 2, "mode": "lstm",
             "state_outputs": True}),
    "RNN/gru-bidirectional": ([("f", (5, 3, 4)), ("u", (432,), -0.5, 0.5),
                               ("f", (2, 3, 6))],
                              {"state_size": 6, "mode": "gru",
                               "bidirectional": True,
                               "state_outputs": True}),
    "RNN/relu-2-bidirectional": ([("f", (5, 3, 4)),
                                  ("u", (384,), -0.5, 0.5),
                                  ("f", (4, 3, 6))],
                                 {"state_size": 6, "num_layers": 2,
                                  "mode": "rnn_relu",
                                  "bidirectional": True}),
    "RNN/tanh": ([("f", (5, 3, 4)), ("u", (72,), -0.5, 0.5),
                  ("f", (1, 3, 6))], {"state_size": 6, "mode": "rnn_tanh",
                                      "state_outputs": True}),
    # the cell state clipped every step, a batch-1 state broadcast
    "RNN/lstm-clip-batch1": ([("f", (5, 3, 4)), ("u", (288,), -0.5, 0.5),
                              ("f", (1, 1, 6)), ("f", (1, 1, 6))],
                             {"state_size": 6, "mode": "lstm",
                              "state_outputs": True,
                              "lstm_state_clip_min": -0.3,
                              "lstm_state_clip_max": 0.3}),
    # the transformer's registered ops: K3 (K4a/K4b backward) on the card,
    # and the interleaved helpers
    "_contrib_flash_attention": ([("f", (2, 2, 9, 8))] * 3,
                                 {"causal": True}),
    "_contrib_flash_attention/cross": ([("f", (2, 3, 5, 8)),
                                        ("f", (2, 3, 7, 8)),
                                        ("f", (2, 3, 7, 8))],
                                       {"sm_scale": 0.25}),
    "_contrib_div_sqrt_dim": ([("f", (2, 3, 8))], {}),
    "_contrib_interleaved_matmul_selfatt_qk": ([("f", (5, 2, 12))],
                                               {"heads": 2}),
    "_contrib_interleaved_matmul_selfatt_valatt": ([("f", (5, 2, 12)),
                                                    ("u", (4, 5, 5), 0, 1)],
                                                   {"heads": 2}),
    "arange_like": ([("f", (3, 4))], {"axis": 1}),
    "arange_like/int32-repeat": ([("i", (2, 6), 0, 5)],
                                 {"start": 1.5, "step": 0.5, "repeat": 2}),
    "diag": ([("f", (3, 4))], {"k": 1}),
    "diag/1d": ([("f", (4,))], {"k": -1}),
    "diag/3d": ([("f", (2, 3, 4))], {}),
    "Pad": ([("f", (2, 3, 4, 5))], {"mode": "constant",
                                    "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                                    "constant_value": 1.5}),
    "Pad/reflect": ([("f", (2, 3, 4, 5))],
                    {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 3, 4)}),
    "Pad/edge": ([("f", (2, 3, 4, 5))],
                 {"mode": "edge", "pad_width": (0, 0, 1, 1, 2, 0, 0, 3)}),
    "_contrib_SyncBatchNorm": ([("f", (2, 3, 4, 5)), ("f", (3,)),
                                ("f", (3,)), ("f", (3,)),
                                ("u", (3,), 0.5, 2.0)],
                               {"fix_gamma": False}),
    # optimizer updates
    "sgd_update": ([_F, _F], {"lr": 0.1, "wd": 1e-3, "clip_gradient": 0.5}),
    "sgd_mom_update": ([_F, _F, _F], {"lr": 0.1, "momentum": 0.9,
                                      "wd": 1e-4}),
    "adam_update": ([_F, _F, _F, ("u", (3, 4), 0.1, 1.0)],
                    {"lr": 0.01, "wd": 1e-3, "rescale_grad": 0.5}),
    "nag_mom_update": ([_F, _F, _F], {"lr": 0.1, "momentum": 0.9,
                                      "wd": 1e-4, "clip_gradient": 1.0}),
    "adamw_update": ([_F, _F, _F, _VAR], {"lr": 0.01, "wd": 1e-3,
                                          "eta": 0.5, "clip_gradient": 0.8}),
    "rmsprop_update": ([_F, _F, _VAR], {"lr": 0.01, "wd": 1e-3,
                                        "clip_weights": 0.5}),
    "rmspropalex_update": ([_F, _F, ("u", (3, 4), 1.0, 2.0),
                            ("u", (3, 4), -0.1, 0.1), _F],
                           {"lr": 0.01, "wd": 1e-3}),
    "adagrad_update": ([_F, _F, _VAR], {"lr": 0.1, "wd": 1e-3}),
    "adadelta_update": ([_F, _F, _VAR, _VAR], {"wd": 1e-3,
                                               "clip_gradient": 1.0}),
    "signsgd_update": ([_F, _F], {"lr": 0.1, "wd": 1e-3}),
    "signum_update": ([_F, _F, _F], {"lr": 0.1, "momentum": 0.9,
                                     "wd": 1e-3, "wd_lh": 0.01}),
    "ftrl_update": ([_F, _F, _F, _VAR], {"lr": 0.1, "lamda1": 0.3,
                                         "wd": 1e-3}),
    # t as the optimizers feed it, a float (an int exponent takes JAX's
    # integer_pow, a product chain, where 1 - beta2**t cancels)
    "ftml_update": ([_F, _F, _F, _VAR, _F], {"lr": 0.01, "wd": 1e-3,
                                             "t": 3.0}),
    "adamax_update": ([_F, _F, _F, _VAR], {"lr": 0.01, "wd": 1e-3,
                                           "t": 2.0}),
    "nadam_update": ([_F, _F, _F, _VAR],
                     {"lr": 0.01, "wd": 1e-3, "t": 2.0, "m_schedule": 0.8,
                      "momentum_t": 0.89, "momentum_t_1": 0.891}),
    "mp_sgd_update": ([_F, _F, _F], {"lr": 0.1, "wd": 1e-3,
                                     "clip_gradient": 0.5}),
    "mp_sgd_mom_update": ([_F, _F, _F, _F], {"lr": 0.1, "momentum": 0.9,
                                             "wd": 1e-3}),
    "multi_sgd_update": ([_F] * 4, {"lrs": (0.1, 0.2), "wds": (1e-3, 0.0),
                                    "num_weights": 2}),
    "multi_sgd_mom_update": ([_F] * 6, {"lrs": (0.1, 0.2),
                                        "wds": (1e-3, 0.0), "momentum": 0.9,
                                        "num_weights": 2}),
    "multi_mp_sgd_update": ([_F] * 6, {"lrs": (0.1, 0.2), "wds": (1e-3, 0.0),
                                       "clip_gradient": 0.5,
                                       "num_weights": 2}),
    "multi_mp_sgd_mom_update": ([_F] * 8, {"lrs": (0.1, 0.2),
                                           "wds": (1e-3, 0.0),
                                           "momentum": 0.9,
                                           "num_weights": 2}),
    # (seq, batch, alphabet) activations; labels 1-based, 0-padded (a
    # repeated label, an empty one), then 0-based, -1-padded with lengths
    "CTCLoss": ([("f", (6, 3, 5)),
                 ("v", [[1, 2, 2], [3, 0, 0], [0, 0, 0]])], {}),
    "CTCLoss/last-lengths": ([("f", (6, 3, 5)),
                              ("v", [[0, 1, 1], [2, -1, -1], [3, 3, -1]]),
                              ("v", [6, 4, 5]), ("v", [3, 1, 2])],
                             {"use_data_lengths": True,
                              "use_label_lengths": True,
                              "blank_label": "last"}),
})
# the custom op of the ``Custom`` case (register_case_op)
CUSTOM_CASE = "_case_square"
OP_CASES["Custom"] = ([_F], {"op_type": CUSTOM_CASE})
RANDOM_OPS = {"_random_uniform", "_random_normal", "_random_randint",
              "_shuffle"}
INPLACE_OPS = {"sgd_update", "sgd_mom_update", "nag_mom_update",
               "adam_update", "adamw_update", "rmsprop_update",
               "rmspropalex_update", "adagrad_update", "adadelta_update",
               "signsgd_update", "signum_update", "ftrl_update",
               "ftml_update", "adamax_update", "nadam_update",
               "mp_sgd_update", "mp_sgd_mom_update", "multi_sgd_update",
               "multi_sgd_mom_update", "multi_mp_sgd_update",
               "multi_mp_sgd_mom_update"}
NO_TENSOR_OPS = {"_zeros", "_ones", "_full", "_arange", "_linspace", "_eye",
                 "_random_uniform", "_random_normal", "_random_randint"}


def op_name(case):
    """The registered op of a case key (``"sum/int32"`` -> ``"sum"``)."""
    return case.split("/")[0]


def updated(case, inputs):
    """The inputs of an :data:`INPLACE_OPS` case that its op updated, in
    the order the JAX op returns their new values: the weights, then each
    state in turn (a ``multi_*`` op's inputs are ``num_weights`` groups of
    weight, gradient and states)."""
    n = int(OP_CASES[case][1].get("num_weights", 1))
    k = len(inputs) // n
    return [inputs[g * k + j] for j in [0] + list(range(2, k))
            for g in range(n)]


def make_inputs(case, seed=0):
    """The numpy inputs of ``OP_CASES[case]``, from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    out = []
    for spec in OP_CASES[case][0]:
        kind = spec[0]
        if kind == "f":
            out.append(rng.randn(*spec[1]).astype(np.float32))
        elif kind == "u":
            out.append(rng.uniform(spec[2], spec[3], spec[1])
                       .astype(np.float32))
        elif kind in ("i", "fi"):
            a = rng.randint(spec[2], spec[3], spec[1])
            out.append(a.astype(np.int32 if kind == "i" else np.float32))
        else:
            dtype = spec[2] if len(spec) > 2 else np.float32
            out.append(np.asarray(spec[1], dtype=dtype))
    return out


def register_case_op(operator):
    """Register :data:`CUSTOM_CASE` (``x * x``, its gradient ``2 x dy``)
    with ``operator``: this package's ``mx.operator`` or the JAX
    package's, whose APIs are the same."""

    class _Square(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @operator.register(CUSTOM_CASE)
    class _SquareProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return _Square()

    return _SquareProp


from . import operator as _operator  # noqa: E402

register_case_op(_operator)


# ------------------------------------------------------------ MXNet's API

_rng = np.random.RandomState(1234)


def default_context():
    """The current context (:func:`~mxnet_tpu_torch.context.
    current_context`: a scope's, else the default, ``gpu(0)``)."""
    from .context import current_context

    return current_context()


def set_default_context(ctx):
    """Make ``ctx`` this thread's default context outside any scope."""
    from .context import set_default

    set_default(ctx)


def default_dtype():
    return np.float32


def rand_shape_2d(dim0=10, dim1=10):
    return (_rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(_rng.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_rng.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 distribution="uniform"):
    """An NDArray on the default context, uniform in [-1, 1) (or
    standard normal); sparse storage types are not ported and raise."""
    from .base import MXNetError
    from .ndarray import array

    del density
    if stype != "default":
        raise MXNetError("rand_ndarray: storage type %r is not ported "
                         "(dense arrays only)" % (stype,))
    if distribution == "normal":
        data = _rng.standard_normal(shape)
    else:
        data = _rng.uniform(-1, 1, size=shape)
    return array(data.astype(dtype or np.float32))


def random_arrays(*shapes):
    arrays = [_rng.standard_normal(size=s).astype(np.float32)
              for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def _as_np(a):
    from .ndarray import NDArray

    if isinstance(a, NDArray):
        return a.asnumpy()
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def find_max_violation(a, b, rtol=None, atol=None):
    """The index of the largest ``|a - b| / (atol + rtol |b|)`` and that
    ratio."""
    a, b = _as_np(a), _as_np(b)
    rtol = rtol or 1e-5
    atol = atol or 1e-20
    violation = np.abs(a - b) / (atol + rtol * np.abs(b) + 1e-37)
    if not violation.size:
        return (), 0.0
    return (np.unravel_index(np.argmax(violation), violation.shape),
            violation.max())


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    a_np, b_np = _as_np(a), _as_np(b)
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    if not np.allclose(a_np, b_np, rtol=rtol, atol=atol,
                       equal_nan=equal_nan):
        idx, max_v = find_max_violation(a_np, b_np, rtol, atol)
        raise AssertionError(
            "Items are not equal (rtol=%g, atol=%g): max violation %.4g at "
            "%s\n %s: %s\n %s: %s" % (rtol, atol, max_v, idx, names[0],
                                       a_np.flat[:10], names[1],
                                       b_np.flat[:10]))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    return np.allclose(_as_np(a), _as_np(b), rtol=rtol or 1e-5,
                       atol=atol or 1e-20, equal_nan=equal_nan)


def same(a, b):
    return np.array_equal(_as_np(a), _as_np(b))


def _arrays(location, names, dtype, ctx):
    from .ndarray import NDArray, array

    if isinstance(location, (list, tuple)):
        location = dict(zip(names, location))
    return {k: v.copyto(ctx) if isinstance(v, NDArray)
            else array(np.asarray(v, dtype=dtype), ctx=ctx)
            for k, v in location.items()}


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None,
                           dtype=np.float32):
    """The executor's gradients of ``sum(outputs[0])`` against central
    differences in float64 arithmetic on the inputs; arguments missing
    from ``location`` are drawn from ``RandomState(0)`` in [-0.5, 0.5) at
    their inferred shapes."""
    from .ndarray import array

    ctx = ctx or default_context()
    location = _arrays(location, sym.list_arguments(), dtype, ctx)
    missing = [n for n in sym.list_arguments() if n not in location]
    if missing:
        shapes, _, _ = sym.infer_shape_partial(
            **{k: v.shape for k, v in location.items()})
        by_name = dict(zip(sym.list_arguments(), shapes))
        rng = np.random.RandomState(0)
        for n in missing:
            if by_name.get(n) is None:
                raise ValueError("cannot infer shape for %r; pass it in "
                                 "location" % n)
            location[n] = array(rng.uniform(-0.5, 0.5, by_name[n])
                                .astype(dtype), ctx=ctx)
    if grad_nodes is None:
        grad_nodes = list(location)
    ex = sym.bind(ctx, {k: v.copy() for k, v in location.items()},
                  args_grad={k: array(np.zeros(v.shape, dtype=dtype),
                                      ctx=ctx)
                             for k, v in location.items() if k in grad_nodes},
                  grad_req={k: ("write" if k in grad_nodes else "null")
                            for k in location},
                  aux_states=aux_states)
    ex.forward(is_train=use_forward_train)
    out = ex.outputs[0]
    ex.backward([array(np.ones(out.shape, dtype=dtype), ctx=ctx)])
    sym_grads = {k: ex.grad_dict[k].asnumpy() for k in grad_nodes}

    def loss_at(loc):
        ex2 = sym.bind(ctx, {k: array(v.astype(dtype), ctx=ctx)
                             for k, v in loc.items()},
                       args_grad=None, grad_req={k: "null" for k in loc},
                       aux_states=aux_states)
        ex2.forward(is_train=use_forward_train)
        return ex2.outputs[0].asnumpy().astype(np.float64).sum()

    base = {k: v.asnumpy().astype(np.float64) for k, v in location.items()}
    for name in grad_nodes:
        flat = base[name].reshape(-1)
        num = np.zeros_like(flat)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + numeric_eps / 2
            fp = loss_at(base)
            flat[i] = orig - numeric_eps / 2
            fm = loss_at(base)
            flat[i] = orig
            num[i] = (fp - fm) / numeric_eps
        assert_almost_equal(sym_grads[name], num.reshape(base[name].shape),
                            rtol=rtol, atol=atol or 1e-4,
                            names=("symbolic_grad(%s)" % name,
                                   "numeric_grad"))


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None, equal_nan=False,
                           dtype=np.float32):
    """The executor's predict-mode outputs against ``expected``; returns
    them as numpy arrays."""
    ctx = ctx or default_context()
    args = _arrays(location, sym.list_arguments(), dtype, ctx)
    ex = sym.bind(ctx, args, grad_req={k: "null" for k in args},
                  aux_states=aux_states)
    outputs = ex.forward(is_train=False)
    if not isinstance(expected, (list, tuple)):
        expected = [expected]
    for out, exp in zip(outputs, expected):
        assert_almost_equal(out, exp, rtol=rtol, atol=atol,
                            equal_nan=equal_nan)
    return [o.asnumpy() for o in outputs]


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None, dtype=np.float32):
    """The executor's gradients (a train-mode forward, then ``out_grads``)
    against ``expected`` (a list in argument order or a dict); returns
    every gradient as numpy arrays."""
    from .ndarray import NDArray, array

    ctx = ctx or default_context()
    args = _arrays(location, sym.list_arguments(), dtype, ctx)
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym.list_arguments(), expected))
    grads = {k: array(np.zeros(v.shape, dtype=dtype), ctx=ctx)
             for k, v in args.items()}
    ex = sym.bind(ctx, args, args_grad=grads, grad_req=grad_req,
                  aux_states=aux_states)
    ex.forward(is_train=True)
    heads = out_grads if isinstance(out_grads, (list, tuple)) \
        else [out_grads]
    ex.backward([g.copyto(ctx) if isinstance(g, NDArray)
                 else array(np.asarray(g, dtype=dtype), ctx=ctx)
                 for g in heads])
    for name, exp in expected.items():
        assert_almost_equal(ex.grad_dict[name], exp, rtol=rtol, atol=atol,
                            names=("grad(%s)" % name, "expected"))
    return {k: v.asnumpy() for k, v in ex.grad_dict.items()}


def _contexts():
    from .context import cpu, gpu, num_gpus

    return [{"ctx": cpu()}] + ([{"ctx": gpu(0)}] if num_gpus() else [])


def check_consistency(sym, ctx_list=None, scale=1.0, rtol=1e-4, atol=1e-4,
                      arg_params=None, aux_params=None, raise_on_err=True):
    """The symbol's predict-mode outputs on every context of ``ctx_list``
    (default: the CPU, and the card where one is present: the reference's
    cpu-against-gpu check) from the same normal draws (``scale``), each
    against the first's; returns every context's outputs."""
    del arg_params, aux_params, raise_on_err
    ctx_list = ctx_list or _contexts()
    shapes = {k: v for spec in ctx_list for k, v in spec.items()
              if k not in ("ctx", "type_dict")}
    results, base = [], None
    for spec in ctx_list:
        ex = sym.simple_bind(ctx=spec["ctx"], grad_req="null", **shapes)
        if base is None:
            base = {n: (_rng.standard_normal(ex.arg_dict[n].shape) * scale)
                    .astype(np.float32) for n in sym.list_arguments()}
        for name, value in base.items():
            ex.arg_dict[name][:] = value
        results.append([o.asnumpy() for o in ex.forward(is_train=False)])
    for res in results[1:]:
        for a, b in zip(results[0], res):
            assert_almost_equal(a, b, rtol=rtol, atol=atol)
    return results


def check_op_consistency(op_name, arrays, attrs=None, rtol=1e-4, atol=1e-4,
                         shard_axis=0):
    """The registered op ``op_name`` on the numpy ``arrays`` three ways:
    imperatively on the CPU, as a graph through an executor on the CPU,
    and imperatively on the card where one is present (the JAX package's
    third way, one op over a mesh of devices, is a card here:
    ``shard_axis`` is accepted and unused); each against the first.
    Returns the imperative outputs as numpy arrays."""
    from . import symbol as _symbol
    from .context import cpu
    from .ndarray import array, imperative_invoke

    del shard_axis
    attrs = dict(attrs or {})

    def eager(ctx):
        return [o.asnumpy() for o in imperative_invoke(
            op_name, [array(a, ctx=ctx, dtype=a.dtype) for a in arrays],
            dict(attrs))]

    first = eager(cpu())
    variables = [_symbol.Variable("in%d" % i) for i in range(len(arrays))]
    out = getattr(_symbol, op_name)(*variables, **attrs)
    by_name = {"in%d" % i: array(a, ctx=cpu(), dtype=a.dtype)
               for i, a in enumerate(arrays)}
    ex = out.bind(cpu(), {n: by_name[n] for n in out.list_arguments()},
                  aux_states={n: by_name[n]
                              for n in out.list_auxiliary_states()})
    runs = [("staged", [o.asnumpy() for o in ex.forward()])]
    runs += [("card", eager(spec["ctx"])) for spec in _contexts()[1:]]
    for name, res in runs:
        assert len(res) == len(first), (op_name, name)
        for a, b in zip(first, res):
            assert_almost_equal(a, b, rtol=rtol, atol=atol,
                                names=("eager", name))
    return first


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    from .ndarray import array

    ctx = ctx or default_context()
    ex = sym.bind(ctx, {k: array(v, ctx=ctx) for k, v in inputs.items()})
    outputs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    return outputs[0] if len(outputs) == 1 else outputs


class DummyIter:
    """One batch of ``real_iter`` repeated forever."""

    def __init__(self, real_iter):
        self.real_iter = real_iter
        self.provide_data = real_iter.provide_data
        self.provide_label = real_iter.provide_label
        self.batch_size = real_iter.batch_size
        self.the_batch = next(real_iter)

    def __iter__(self):
        return self

    def next(self):
        return self.the_batch

    __next__ = next


def get_mnist():
    """The MNIST arrays (``train_data``, ``train_label``, ``test_data``,
    ``test_label``) of :class:`~mxnet_tpu_torch.io.MNISTIter`: the idx
    files where present, else its synthetic digits (no download)."""
    from .io.io import MNISTIter

    def collect(which):
        it = MNISTIter(image=which, batch_size=100, shuffle=False)
        it.reset()
        data, label = [], []
        for b in it:
            data.append(b.data[0].asnumpy())
            label.append(b.label[0].asnumpy())
        return np.concatenate(data), np.concatenate(label)

    train_img, train_lbl = collect("train")
    test_img, test_lbl = collect("val")
    return {"train_data": train_img, "train_label": train_lbl,
            "test_data": test_img, "test_label": test_lbl}


def get_mnist_iterator(batch_size, input_shape, num_parts=1, part_index=0):
    """``(train, val)`` :class:`~mxnet_tpu_torch.io.MNISTIter`s, flat when
    ``input_shape`` has one dimension."""
    from .io.io import MNISTIter

    flat = len(input_shape) == 1
    train = MNISTIter(image="train", batch_size=batch_size, shuffle=True,
                      flat=flat, num_parts=num_parts, part_index=part_index)
    val = MNISTIter(image="val", batch_size=batch_size, shuffle=False,
                    flat=flat)
    return train, val


def download(url, fname=None, dirname=None, overwrite=False, retries=5):
    """Raises: the port downloads nothing; stage files locally."""
    raise RuntimeError("test_utils.download(%r): the port downloads "
                       "nothing; stage the file locally instead" % (url,))


# ------------------------------------------------- float64 references


def _conv_dw_float64(x, dy, kernel, stride=(1, 1), pad=(0, 0),
                     dilate=(1, 1), groups=1):
    """A 2-D convolution's NHWC/OHWI dW in ``x``'s dtype by
    ``aten.convolution_backward`` (the kernels' wrappers take the 16- and
    32-bit types only)."""
    import torch

    w = torch.empty((dy.shape[3], x.shape[3] // groups) + tuple(kernel),
                    dtype=x.dtype)
    dw = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, stride, pad,
        dilate, False, (0, 0), groups, (False, True, False))[1]
    return dw.permute(0, 2, 3, 1)


def _maxpool_bwd_float64(x, dy, kernel, stride, pad=(0, 0)):
    """A max pool's NHWC dX in ``dy``'s dtype, routed to the first
    largest tap of each window as the kernel routes it."""
    import torch

    from .ops.pool_bwd import _first_argmax, _tap_view

    kh, kw = kernel
    h, w = x.shape[1], x.shape[2]
    oh, ow = dy.shape[1], dy.shape[2]
    idx, xp = _first_argmax(x, dy, kernel, stride, pad)
    dxp = torch.zeros(xp.shape, dtype=dy.dtype)
    for t in reversed(range(kh * kw)):
        view = _tap_view(dxp, t // kw, t % kw, stride, oh, ow)
        view += torch.where(idx == t, dy, torch.zeros_like(dy))
    return dxp[:, pad[0]:pad[0] + h, pad[1]:pad[1] + w]


def _attention_float64(q, k, v, causal=False, sm_scale=None,
                       return_lse=False):
    """Softmax attention as one plain expression in ``q``'s dtype."""
    import torch

    if return_lse:
        from .base import MXNetError

        raise MXNetError("the float64 reference gives no lse")
    s = q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5 if sm_scale is None
                                   else sm_scale)
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                     device=s.device).triu(1),
                          float("-inf"))
    return torch.softmax(s, -1) @ v


@contextlib.contextmanager
def float64_reference():
    """While open, the port's CPU path takes float64 where its kernels'
    wrappers take the 16- and 32-bit types only: a convolution's
    weight-gradient, a max pool's dX and attention run as plain float64
    PyTorch.  A network
    cast to float64 then gives the float64 result that a test holds both
    packages' float32 results against, to tell their rounding from a
    divergence."""
    from .ops import attention, nn

    saved = nn.conv_dw, nn.maxpool_bwd, attention.flash_attention
    nn.conv_dw, nn.maxpool_bwd, attention.flash_attention = (
        _conv_dw_float64, _maxpool_bwd_float64, _attention_float64)
    try:
        yield
    finally:
        nn.conv_dw, nn.maxpool_bwd, attention.flash_attention = saved


def within_float64_rounding(got, jax_got, ref, dtype=np.float32):
    """The largest errors of the port's result ``got`` and the JAX
    package's ``jax_got`` against a float64 ``ref`` (arrays, or dicts of
    arrays taken as one output), and the limit the port's is held to:
    twice the JAX package's error plus one unit in the last place of
    ``dtype`` at the output's scale."""
    if not isinstance(ref, dict):
        got, jax_got, ref = {0: got}, {0: jax_got}, {0: ref}
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    e_port = max(float(np.abs(np.asarray(got[k], np.float64) - r).max())
                 for k, r in ref.items())
    e_jax = max(float(np.abs(np.asarray(jax_got[k], np.float64) - r).max())
                for k, r in ref.items())
    scale = max(float(np.abs(r).max()) for r in ref.values())
    return e_port, e_jax, 2 * e_jax + float(np.spacing(dtype(scale)))
