"""NDArray of the PyTorch port: the imperative array over one ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` (reference:
include/mxnet/ndarray.h:82, python/mxnet/ndarray/ndarray.py).

- An ``NDArray`` wraps one tensor, zero-copy: ``NDArray(t)`` and
  :attr:`NDArray.data_torch` cross between the two, so Gluon parameters
  and gradients enter ``mx.nd`` as they are.  ``dtype`` is a numpy dtype
  (bfloat16, which numpy lacks, is ``torch.bfloat16``); ``context`` is the
  tensor's ``torch.device``.
- PyTorch's stream order is the engine: ops return at once,
  ``asnumpy``/``wait_to_read``/:func:`waitall` are the sync points.
- Basic indexing (ints, slices, None, Ellipsis) returns a torch view, so
  ``v[:] = x`` and ``v += x`` write through to the parent; advanced
  indexing and every op return new arrays.  A slice with a negative step
  is read as a copy and cannot be assigned to.
- Ops dispatch through the registry (:func:`imperative_invoke`) with
  PyTorch's grad mode set to :func:`~mxnet_tpu_torch.autograd.is_recording`,
  so PyTorch's graph is the tape and nothing outside ``record`` is
  differentiable.  An in-place write (``+=``, ``[]=``, ``out=``) on an
  array that requires grad while recording raises :class:`MXNetError`.
- ``save``/``load`` use the JAX package's npz container: a ``__format__``
  entry of ``"dict"`` or ``"list"``, so files of either package load
  into the other.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from .. import autograd as _ag
from ..base import (MXNetError, np_dtype, numeric_types, saturating_cast,
                    torch_dtype)
from ..context import resolve_device
from ..ops import init_ops as _init
from ..ops import registry as _reg
from ..ops.matrix import encode_basic_index

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "maximum", "minimum", "moveaxis", "stack_arrays",
           "waitall", "imperative_invoke", "save", "load", "read_npz"]


def _grad_mode():
    """PyTorch's grad mode for imperative work: on only while recording."""
    return torch.set_grad_enabled(_ag.is_recording())


class NDArray:
    """An n-dimensional array on a device (``gpu(0)`` unless asked)."""

    __slots__ = ("_t", "__weakref__")

    # numpy defers to NDArray in mixed expressions (np * nd)
    __array_priority__ = 1000.0

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %s; use "
                            "nd.array() for other sources"
                            % type(data).__name__)
        self._t = data

    # ------------------------------------------------------------ basics
    @property
    def data_torch(self):
        """The underlying ``torch.Tensor`` (no copy)."""
        return self._t

    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return np_dtype(self._t.dtype)

    @property
    def size(self):
        return self._t.numel()

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def context(self):
        return self._t.device

    ctx = context

    @property
    def stype(self):
        return "default"

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (self.asnumpy(),
                                         "x".join(map(str, self.shape)),
                                         self.context)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------- sync
    def asnumpy(self):
        """A numpy copy on the host (waits for the value); bfloat16 comes
        back as float32."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().item()

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        if self._t.is_cuda:
            torch.cuda.current_stream(self._t.device).synchronize()

    wait_to_write = wait_to_read

    # ------------------------------------------------------ dtype/device
    def astype(self, dtype, copy=True):
        """A copy in ``dtype`` (floats to integers truncate and saturate,
        NaN to 0, as the JAX package converts)."""
        dt = torch_dtype(dtype)
        if not copy and self._t.dtype == dt:
            return self
        with _grad_mode():
            out = saturating_cast(self._t, dt)
            return NDArray(out.clone() if out is self._t else out)

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        if dev == self._t.device:
            return self
        with _grad_mode():
            return NDArray(self._t.to(dev))

    as_in_ctx = as_in_context

    def copyto(self, other):
        """Copy into another NDArray (cast to its dtype) or onto a device."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError("copyto shape mismatch %s vs %s"
                                 % (self.shape, other.shape))
            other._write(self._t, "copyto")
            return other
        with _grad_mode():
            return NDArray(self._t.to(resolve_device(other), copy=True))

    def copy(self):
        with _grad_mode():
            return NDArray(self._t.clone())

    def detach(self):
        return NDArray(self._t.detach())

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage (%r) is not ported" % (stype,))
        return self

    # ---------------------------------------------------------- mutation
    def _check_inplace(self, what):
        if _ag.is_recording() and self._t.requires_grad:
            raise MXNetError(
                "%s: in-place write on an array that requires grad while "
                "autograd is recording" % what)

    def _write(self, value, what):
        """``self[...] = value`` (broadcast, cast to this dtype)."""
        self._check_inplace(what)
        try:
            with _grad_mode():
                self._t.copy_(value)
        except RuntimeError as e:
            raise MXNetError("%s: %s" % (what, e)) from e

    def __setitem__(self, key, value):
        self._check_inplace("__setitem__")
        if isinstance(value, NDArray):
            value = value._t
        elif not isinstance(value, (numeric_types, torch.Tensor)):
            value = torch.as_tensor(np.asarray(value), device=self._t.device)
        key = _clean_index(key)
        if _negative_step(key):
            raise MXNetError("__setitem__: a slice with a negative step "
                             "cannot be assigned to")
        try:
            with _grad_mode():
                self._t[key] = value
        except RuntimeError as e:
            raise MXNetError("__setitem__: %s" % e) from e

    def __getitem__(self, key):
        key = _clean_index(key)
        if _is_basic_index(key) and _negative_step(key):
            return imperative_invoke("_basic_index", [self],
                                     {"key": encode_basic_index(key)})[0]
        with _grad_mode():
            return NDArray(self._t[key])

    def slice(self, begin, end, step=None):
        return imperative_invoke("slice", [self], {"begin": begin,
                                                   "end": end,
                                                   "step": step or ()})[0]

    def slice_axis(self, axis, begin, end):
        return imperative_invoke("slice_axis", [self],
                                 {"axis": axis, "begin": begin,
                                  "end": end})[0]

    # ---------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable with a zero gradient buffer
        (reference: attach_grad -> MXAutogradMarkVariables)."""
        if stype not in (None, "default"):
            raise MXNetError("sparse gradients are not ported")
        if not self._t.is_leaf:
            self._t = self._t.detach()
        _ag.mark_variables([self], [torch.zeros_like(self._t)], grad_req)

    @property
    def grad(self):
        g = self._t.grad
        return None if g is None else NDArray(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], None if out_grad is None else [out_grad],
                     retain_graph=retain_graph, train_mode=train_mode)

    # ---------------------------------------------------- fluent methods
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return imperative_invoke("Reshape", [self], {
            "shape": shape, "reverse": kwargs.get("reverse", False)})[0]

    def reshape_like(self, other):
        return imperative_invoke("reshape_like", [self, other], {})[0]

    def expand_dims(self, axis):
        return imperative_invoke("expand_dims", [self], {"axis": axis})[0]

    def squeeze(self, axis=None):
        return imperative_invoke("squeeze", [self], {"axis": axis})[0]

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return imperative_invoke("transpose", [self], {"axes": axes})[0]

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return imperative_invoke("Flatten", [self], {})[0]

    def flip(self, axis):
        return imperative_invoke("reverse", [self], {"axis": axis})[0]

    def _reduce(self, op, **attrs):
        return imperative_invoke(op, [self], attrs)[0]

    def sum(self, axis=None, keepdims=False, dtype=None, **_):
        return self._reduce("sum", axis=axis, keepdims=keepdims, dtype=dtype)

    def mean(self, axis=None, keepdims=False, dtype=None, **_):
        return self._reduce("mean", axis=axis, keepdims=keepdims,
                            dtype=dtype)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._reduce("norm", ord=ord, axis=axis, keepdims=keepdims)

    def pick(self, index, axis=-1, keepdims=False, mode="clip"):
        return imperative_invoke("pick", [self, index], {
            "axis": axis, "keepdims": keepdims, "mode": mode})[0]

    def abs(self):
        return self._reduce("abs")

    def sqrt(self):
        return self._reduce("sqrt")

    def square(self):
        return self._reduce("square")

    def exp(self):
        return self._reduce("exp")

    def log(self):
        return self._reduce("log")

    def sigmoid(self):
        return self._reduce("sigmoid")

    def tanh(self):
        return self._reduce("tanh")

    def relu(self):
        return self._reduce("relu")

    def softmax(self, axis=-1):
        return self._reduce("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._reduce("log_softmax", axis=axis)

    def clip(self, a_min, a_max):
        return self._reduce("clip", a_min=a_min, a_max=a_max)

    def round(self):
        return self._reduce("round")

    def sign(self):
        return self._reduce("sign")

    def sort(self, axis=-1, is_ascend=True):
        return self._reduce("sort", axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return self._reduce("argsort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        out = imperative_invoke("topk", [self], {
            "axis": axis, "k": k, "ret_typ": ret_typ,
            "is_ascend": is_ascend})
        return out if len(out) > 1 else out[0]

    def take(self, indices, axis=0, mode="clip"):
        return imperative_invoke("take", [self, _as_nd(indices,
                                                       self.context)],
                                 {"axis": axis, "mode": mode})[0]

    def one_hot(self, depth, **kw):
        return imperative_invoke("one_hot", [self], dict(depth=depth,
                                                          **kw))[0]

    def broadcast_to(self, shape):
        return self._reduce("broadcast_to", shape=shape)

    def broadcast_like(self, other):
        return imperative_invoke("broadcast_like", [self, other], {})[0]

    def tile(self, reps):
        return self._reduce("tile", reps=reps)

    def repeat(self, repeats, axis=None):
        return self._reduce("repeat", repeats=repeats, axis=axis)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return imperative_invoke("SliceChannel", [self], {
            "num_outputs": num_outputs, "axis": axis,
            "squeeze_axis": squeeze_axis})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return imperative_invoke("dot", [self, other], {
            "transpose_a": transpose_a, "transpose_b": transpose_b})[0]

    # -------------------------------------------------------- arithmetic
    def _binop(self, other, opname, scalarname, reverse=False):
        if isinstance(other, NDArray):
            args = [other, self] if reverse else [self, other]
            return imperative_invoke(opname, args, {})[0]
        if isinstance(other, numeric_types):
            if reverse and scalarname in _SCALAR_REV:
                scalarname = _SCALAR_REV[scalarname]
            return imperative_invoke(scalarname, [self],
                                     {"scalar": float(other)})[0]
        return self._binop(array(other, ctx=self.context), opname,
                           scalarname, reverse)

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar",
                           reverse=True)

    def __matmul__(self, o):
        """numpy ``@``: a matrix product, batched over leading axes."""
        other = _as_nd(o, self.context)._t
        with _grad_mode():
            return NDArray(torch.matmul(self._t, other))

    def __rmatmul__(self, o):
        other = _as_nd(o, self.context)._t
        with _grad_mode():
            return NDArray(torch.matmul(other, self._t))

    def __neg__(self):
        return imperative_invoke("negative", [self], {})[0]

    def __abs__(self):
        return self.abs()

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def _inplace(self, result, what):
        self._write(result._t, what)
        return self

    def __iadd__(self, o):
        return self._inplace(self + o, "__iadd__")

    def __isub__(self, o):
        return self._inplace(self - o, "__isub__")

    def __imul__(self, o):
        return self._inplace(self * o, "__imul__")

    def __itruediv__(self, o):
        return self._inplace(self / o, "__itruediv__")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


_SCALAR_REV = {"_minus_scalar": "_rminus_scalar",
               "_div_scalar": "_rdiv_scalar",
               "_mod_scalar": "_rmod_scalar",
               "_power_scalar": "_rpower_scalar"}


def _index_tensor(k):
    """An index array as int64 (floats truncated toward zero, as the JAX
    package's int32 cast)."""
    t = k._t if isinstance(k, NDArray) else torch.as_tensor(np.asarray(k))
    return t.to(torch.int64) if t.dtype != torch.bool else t


def _clean_index(key):
    if isinstance(key, (NDArray, list, np.ndarray)):
        return _index_tensor(key)
    if isinstance(key, tuple):
        return tuple(_index_tensor(k) if isinstance(k, (NDArray, list,
                                                        np.ndarray)) else k
                     for k in key)
    return key


def _is_basic_index(key):
    def basic(k):
        return (isinstance(k, (int, builtins.slice)) and not isinstance(
            k, bool)) or k is Ellipsis or k is None

    if isinstance(key, tuple):
        return all(basic(k) for k in key)
    return basic(key)


def _negative_step(key):
    return any(isinstance(k, builtins.slice) and k.step is not None
               and k.step < 0
               for k in (key if isinstance(key, tuple) else (key,)))


def _as_nd(x, ctx=None):
    return x if isinstance(x, NDArray) else array(x, ctx=ctx)


# ------------------------------------------------------------ dispatch


def _storage(t):
    return t.untyped_storage().data_ptr()


def imperative_invoke(op_name, inputs, attrs, out=None):
    """The imperative dispatch: unwrap, call the registered op, wrap.

    Counterpart of JAX ``ndarray.py:713`` (reference: MXImperativeInvokeEx
    -> Imperative::Invoke).  Attributes of None are dropped; the op runs
    with PyTorch's grad mode set to the recording flag, so under
    ``autograd.record`` PyTorch's graph records it.  An output that
    shares memory with an input is copied (ops return new arrays), except
    an input the op updated in place and returned (the optimizer ops),
    which comes back as that NDArray.  ``out=`` receives the results, cast to its
    dtype; op failures surface as :class:`MXNetError`."""
    op = _reg.get(op_name)
    attrs = op.canonicalize_attrs({k: v for k, v in attrs.items()
                                   if v is not None})
    tensors = [a._t if isinstance(a, NDArray) else a for a in inputs]
    versions = [getattr(t, "_version", None) for t in tensors]
    try:
        with _grad_mode():
            result = op.fn(*tensors, **attrs)
    except (TypeError, ValueError, RuntimeError, IndexError) as e:
        if isinstance(e, MXNetError):
            raise
        raise MXNetError("%s: %s" % (op_name, e)) from e
    result = result if isinstance(result, (tuple, list)) else (result,)
    in_storage = {_storage(t) for t in tensors
                  if isinstance(t, torch.Tensor) and t.numel()}
    nds = []
    for r in result:
        i = next((i for i, t in enumerate(tensors) if t is r), None)
        if i is not None and r._version != versions[i]:
            nds.append(inputs[i] if isinstance(inputs[i], NDArray)
                       else NDArray(r))
            continue
        if r.numel() and _storage(r) in in_storage:
            with _grad_mode():
                r = r.clone()
        nds.append(NDArray(r))
    if out is None:
        return nds
    outs = out if isinstance(out, (list, tuple)) else [out]
    for dst, src in zip(outs, nds):
        if dst._t is not src._t:
            dst._write(src._t, op_name + " out=")
    return list(outs)


# ------------------------------------------------------------ creation


def array(source, ctx=None, dtype=None):
    """A new array from an NDArray, a tensor, a numpy array, a list or a
    scalar, on ``ctx`` (default ``gpu(0)``).  Typed sources keep their
    dtype, but float64 narrows to float32; lists and scalars are float32
    (reference: python/mxnet/ndarray/utils.py array)."""
    dev = resolve_device(ctx)
    if isinstance(source, (NDArray, torch.Tensor)):
        src = source._t if isinstance(source, NDArray) else source
        src = src.detach()
    else:
        typed = isinstance(source, np.ndarray)
        src = np.asarray(source)
        if not typed:
            src = src.astype(np.float32)
        src = torch.from_numpy(np.ascontiguousarray(src))
    if dtype is not None:
        dt = torch_dtype(dtype)
    elif src.dtype == torch.float64:
        dt = torch.float32
    else:
        dt = src.dtype
    return NDArray(src.to(device=dev, dtype=dt, copy=True))


def zeros(shape, ctx=None, dtype=None, **_):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(_init.zeros(shape, dtype or "float32", ctx))


def empty(shape, ctx=None, dtype=None):
    """Zeros, as the JAX package (``nd.empty`` promises no contents)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=None, **_):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(_init.ones(shape, dtype or "float32", ctx))


def full(shape, val, ctx=None, dtype=None, **_):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(_init.full(shape, val, dtype or "float32", ctx))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return imperative_invoke("_arange", [], {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "dtype": dtype, "ctx": ctx})[0]


def concatenate(arrays, axis=0, always_copy=True):
    return imperative_invoke("Concat", list(arrays), {"dim": axis})[0]


def stack_arrays(arrays, axis=0):
    return imperative_invoke("stack", list(arrays), {"axis": axis})[0]


def moveaxis(tensor, source, destination):
    with _grad_mode():
        return NDArray(torch.movedim(tensor._t, source, destination)
                       .clone())


def maximum(lhs, rhs):
    """Element-wise maximum of arrays and scalars (reference:
    python/mxnet/ndarray/ndarray.py maximum)."""
    return _scalar_or_broadcast(lhs, rhs, "broadcast_maximum",
                                "_maximum_scalar", builtins.max)


def minimum(lhs, rhs):
    return _scalar_or_broadcast(lhs, rhs, "broadcast_minimum",
                                "_minimum_scalar", builtins.min)


def _scalar_or_broadcast(lhs, rhs, array_op, scalar_op, py_fn):
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return imperative_invoke(array_op, [lhs, rhs], {})[0]
    if isinstance(lhs, NDArray):
        return imperative_invoke(scalar_op, [lhs], {"scalar": float(rhs)})[0]
    if isinstance(rhs, NDArray):
        return imperative_invoke(scalar_op, [rhs], {"scalar": float(lhs)})[0]
    return py_fn(lhs, rhs)


def waitall():
    """Wait for all work queued on every card (reference: MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ----------------------------------------------------------- save/load


def _to_numpy(v):
    if isinstance(v, NDArray):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save(fname, data):
    """Write an array, a list of arrays or a dict of arrays to ``fname``;
    NDArrays, tensors and numpy arrays are accepted.  The file name is
    used as given."""
    if isinstance(data, (NDArray, torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        arrays = {k: _to_numpy(v) for k, v in data.items()}
        fmt = "dict"
    elif isinstance(data, (list, tuple)):
        arrays = {"arr_%d" % i: _to_numpy(v) for i, v in enumerate(data)}
        fmt = "list"
    else:
        raise TypeError("save expects an array, a list or a dict")
    with open(fname, "wb") as f:
        np.savez(f, __format__=fmt, **arrays)


def _parse_npz(data):
    """Saved blob -> ``("list", [numpy...])`` or ``("dict", {name: numpy})``."""
    try:
        fmt = str(data["__format__"])
    except KeyError:
        fmt = "dict"
    if fmt == "list":
        n = len([k for k in data.files if k.startswith("arr_")])
        return "list", [data["arr_%d" % i] for i in range(n)]
    return "dict", {k: data[k] for k in data.files if k != "__format__"}


def read_npz(fname):
    """The arrays of a saved file as numpy, without placing them anywhere."""
    with np.load(fname, allow_pickle=False) as data:
        return _parse_npz(data)[1]


def load(fname, ctx=None):
    """Read a saved file into NDArrays on ``ctx`` (default ``gpu(0)``): a
    list or a dict, as it was saved (float64 narrows to float32, as
    :func:`array`)."""
    parsed = read_npz(fname)
    if isinstance(parsed, list):
        return [array(v, ctx=ctx) for v in parsed]
    return {k: array(v, ctx=ctx) for k, v in parsed.items()}
