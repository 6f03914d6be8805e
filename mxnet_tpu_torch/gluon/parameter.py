"""Gluon parameters of the PyTorch port: ``Parameter``, ``Constant``,
``ParameterDict``.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference:
python/mxnet/gluon/parameter.py).  A :class:`Parameter` is the
reference's handle: a name (its block's prefix and its own), a shape that
may hold 0s until the first input, a dtype, ``grad_req``, ``lr_mult``,
``wd_mult`` and an initializer, with ``data()``, ``grad()``,
``set_data``, ``initialize``, ``reset_ctx``, ``cast`` and ``var()``.

The handle owns one tensor, its *storage*: a :class:`ParameterTensor`
(a ``torch.nn.Parameter``) made when the handle joins a block (on the
block's device, zeros until :meth:`Parameter.initialize`) or when it is
initialized alone.  The block registers the storage in its
``_parameters`` under the attribute's name, so ``state_dict()``,
``torch.func.functional_call``, the hybridize cache and the captured
training steps read and swap tensors as PyTorch modules do, while
``block.weight`` is the handle.  The storage carries ``grad_req``,
``lr_mult`` and ``wd_mult`` (the Trainer and the optimizers read them
there) and ``_handle``, the way back.  ``data()`` and ``grad()`` wrap the
storage and its ``.grad`` as NDArrays without a copy; ``set_data`` copies
in place, so captured programs keep reading the same memory;
``reset_ctx`` and ``cast`` replace the storage's memory, which moves
:func:`cast_generation` and drops every captured program.  A shape with a
0 makes a :class:`DeferredParameter` storage (PyTorch's
``UninitializedParameter``) that :func:`materialize` turns, the same
object, into a :class:`ParameterTensor` once the shape is known.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .. import initializer as _init
from .. import ndarray
from ..base import MXNetError, np_dtype, torch_dtype
from ..context import cpu, gpu, resolve_device

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "ParameterTensor", "DeferredParameter",
           "cast_generation", "is_deferred", "materialize"]

_generation = [0]  # storage replacements (cast, reset_ctx) so far


def cast_generation():
    """How many storage replacements (``cast``, ``reset_ctx``) have run.
    A replacement moves the memory that captured programs read, so every
    cache of them (a hybridized block's, a training step's) is dropped
    when this moves."""
    return _generation[0]


def _bump_generation():
    _generation[0] += 1


class DeferredInitializationError(MXNetError):
    """A parameter used before its shape is known (reference:
    ``gluon/parameter.py`` DeferredInitializationError)."""


class ParameterTensor(nn.Parameter):
    """A parameter's storage: an ``nn.Parameter`` with the reference's
    ``grad_req`` (``'write'``: :func:`~mxnet_tpu_torch.autograd.backward`
    replaces ``.grad``; ``'add'``: adds to it; ``'null'``: no gradient,
    ``requires_grad`` False), ``lr_mult`` and ``wd_mult``."""

    lr_mult = 1.0
    wd_mult = 1.0
    _handle_ref = None

    @property
    def _handle(self):
        """The :class:`Parameter` that owns this storage, or None.  The
        link back is weak, so that a block, its handles and their storage
        are freed by reference counting when the block is dropped."""
        ref = self._handle_ref
        return None if ref is None else ref()

    @_handle.setter
    def _handle(self, handle):
        self._handle_ref = weakref.ref(handle)

    @property
    def grad_req(self):
        return getattr(self, "_grad_req", "write")

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %r" % (req,))
        self._grad_req = req
        self.requires_grad = req != "null"
        if req == "null":
            self.grad = None


class DeferredParameter(UninitializedParameter, ParameterTensor):
    """A storage whose shape waits for the first input (reference:
    deferred initialization).  ``declared_shape`` holds the known
    dimensions and 0 for each unknown one (None: not even the rank).
    :func:`materialize` turns it, the same Python object, into a
    :class:`ParameterTensor`, so the Trainer and captured programs that
    hold it keep holding it."""

    cls_to_become = ParameterTensor


def is_deferred(p):
    """Whether ``p`` (a storage or a :class:`Parameter`) still waits for
    its shape."""
    if isinstance(p, Parameter):
        p = p._storage
    return isinstance(p, DeferredParameter)


def materialize(p, shape):
    """Give the deferred storage ``p`` its ``shape`` (each known dimension
    must agree) on its pending device and dtype, and fill it: by the
    initializer that ``initialize`` recorded, else with zeros."""
    shape = tuple(int(s) for s in shape)
    declared = p.declared_shape
    if declared is not None and (len(shape) != len(declared) or any(
            d and d != s for d, s in zip(declared, shape))):
        raise MXNetError("a deferred parameter of shape %s cannot take the "
                         "shape %s" % (declared, shape))
    pending = getattr(p, "_pending_init", None)
    p.materialize(shape, device=getattr(p, "_pending_device", None),
                  dtype=getattr(p, "_pending_dtype", None))
    p._pending_init = None
    with torch.no_grad():
        if pending is None:
            p.zero_()
        else:
            explicit, default, rng = pending
            handle = p._handle
            p.copy_(torch.from_numpy(_draw(handle, p.shape, explicit,
                                           default, rng)))
            handle._initialized = True


def _own_filler(ini):
    """Whether ``ini`` fills a whole array itself (``_init_weight``), as
    opposed to dispatching by name (``Mixed``, ``Load``)."""
    return type(ini)._init_weight is not _init.Initializer._init_weight


def _draw(handle, shape, explicit, default, rng):
    """``handle``'s initial values of ``shape``: ``explicit`` (or the
    handle's own initializer) fills the whole array; else ``default``
    dispatches by the handle's name."""
    arr = np.zeros(tuple(shape), dtype=np.float32)
    own = explicit if explicit is not None else handle.init
    if own is not None:
        ini = _init.create(own)
        if _own_filler(ini):
            ini._init_weight(arr, rng)
        else:
            ini(_init.InitDesc(handle.name), arr, rng)
    else:
        default(_init.InitDesc(handle.name), arr, rng)
    return arr


def context_of(device):
    """The :class:`Context` of a ``torch.device``."""
    return gpu(device.index or 0) if device.type == "cuda" else cpu()


def _one_device(ctx):
    """``ctx`` (a context, a device or a list of one) as one
    ``torch.device``; a list of several raises (the port trains on one
    device: ROADMAP Queue 1 item 9)."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError("parameters on %d devices: the port keeps a "
                             "parameter on one device (multi-GPU training "
                             "is ROADMAP Queue 1 item 9)" % len(ctx))
        ctx = ctx[0]
    return resolve_device(ctx)


def _as_tensor(data):
    if isinstance(data, ndarray.NDArray):
        return data.data_torch
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.ascontiguousarray(np.asarray(data)))


class Parameter:
    """A block's weight (reference: ``gluon.Parameter``).  See the module
    docstring for how it owns its tensor."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise MXNetError("Parameter %s: sparse storage (%s, %s) is not "
                             "ported" % (name, stype, grad_stype))
        self.name = name
        self._shape = None if shape is None else tuple(
            int(s) for s in ([shape] if isinstance(shape, int) else shape))
        self._dtype = dtype
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._storage = None
        self._initialized = False
        self._lr_mult = lr_mult
        self._wd_mult = wd_mult
        self._grad_req = "write"
        self.grad_req = "null" if not differentiable else grad_req

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    # ------------------------------------------------ delegated attributes
    def _get(self, attr):
        return getattr(self._storage if self._storage is not None else self,
                       attr if self._storage is not None else "_" + attr)

    def _set(self, attr, value):
        setattr(self, "_" + attr, value)
        if self._storage is not None:
            setattr(self._storage, attr, value)

    @property
    def grad_req(self):
        return self._get("grad_req")

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %r" % (req,))
        self._set("grad_req", req if self._differentiable else "null")

    @property
    def lr_mult(self):
        return self._get("lr_mult")

    @lr_mult.setter
    def lr_mult(self, v):
        self._set("lr_mult", v)

    @property
    def wd_mult(self):
        return self._get("wd_mult")

    @wd_mult.setter
    def wd_mult(self, v):
        self._set("wd_mult", v)

    @property
    def shape(self):
        s = self._storage
        if s is not None and not is_deferred(s):
            return tuple(s.shape)
        return self._shape

    @shape.setter
    def shape(self, new):
        new = None if new is None else tuple(int(v) for v in new)
        if new is not None and self._shape is not None \
                and len(new) == len(self._shape):
            new = tuple(n if n > 0 else o for n, o in zip(new, self._shape))
        s = self._storage
        if s is not None and not is_deferred(s) and new is not None \
                and new != tuple(s.shape):
            raise MXNetError("Parameter %s has shape %s; it cannot take %s"
                             % (self.name, tuple(s.shape), new))
        self._shape = new

    @property
    def dtype(self):
        return np_dtype(self._storage.dtype if self._storage is not None
                        else torch_dtype(self._dtype))

    @dtype.setter
    def dtype(self, dtype):
        self._dtype = dtype

    @property
    def stype(self):
        return "default"

    # ------------------------------------------------------------ storage
    def _attach(self, device):
        """The storage, made on ``device`` (zeros, or deferred while the
        shape holds a 0) if the handle has none yet."""
        if self._storage is not None:
            return self._storage
        dt = torch_dtype(self._dtype)
        shape = self._shape
        if shape is None or 0 in shape:
            p = DeferredParameter(device=device, dtype=dt)
            p.declared_shape = shape
        else:
            p = ParameterTensor(torch.zeros(shape, dtype=dt, device=device))
        p.init = self.init
        p._handle = self
        p.lr_mult, p.wd_mult = self._lr_mult, self._wd_mult
        p.grad_req = self._grad_req
        self._storage = p
        return p

    def _check(self, ctx=None):
        s = self._storage
        if s is None:
            raise RuntimeError(
                "Parameter %s has not been initialized. You should "
                "initialize parameters with Block.initialize() (or "
                "Parameter.initialize()) before use." % self.name)
        if is_deferred(s):
            raise DeferredInitializationError(
                "Parameter %s has not been initialized yet because its shape "
                "is unknown (deferred init). Run a forward pass first or set "
                "the full shape." % self.name)
        if ctx is not None and resolve_device(ctx) != s.device:
            raise RuntimeError("Parameter %s was not initialized on context "
                               "%s (it lives on %s)"
                               % (self.name, ctx, context_of(s.device)))
        return s

    def _move(self, device):
        """Put the storage on ``device``, replacing its memory."""
        s = self._storage
        if is_deferred(s):
            s._pending_device = device
            return
        if s.device != device:
            _bump_generation()
            s.data = s.data.to(device)
            s.grad = None

    # -------------------------------------------------------------- init
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, rng=None):
        """Fill the parameter on ``ctx`` (default: where it lives, or the
        current context): ``init`` or its own initializer fills the whole
        array; else ``default_init`` (``Uniform()``) by the name's suffix.
        An initialized parameter is left alone unless ``force_reinit``.
        While the shape holds a 0 the draw waits for the first input.
        ``rng``: a ``numpy.random.RandomState`` (default the port's host
        generator, :func:`mxnet_tpu_torch.random.host_rng`)."""
        if default_init is None:
            default_init = _init.Uniform()
        if isinstance(default_init, str):
            default_init = _init.create(default_init)
        if self._initialized and not force_reinit:
            return
        if rng is None:
            from ..random import host_rng

            rng = host_rng()
        s = self._storage
        if ctx is None:
            dev = resolve_device(None) if s is None else \
                getattr(s, "_pending_device", None) or s.device
        else:
            dev = _one_device(ctx)
        s = self._attach(dev)
        self._move(dev)
        if is_deferred(s):
            shape = self._shape
            if shape is not None and 0 not in shape:
                s._pending_init = None
                materialize(s, shape)
            else:
                if not self.allow_deferred_init and s.declared_shape is None:
                    raise ValueError("Cannot initialize Parameter %s because "
                                     "it has invalid shape %s."
                                     % (self.name, self.shape))
                s._pending_init = (init, default_init, rng)
                return
        with torch.no_grad():
            s.copy_(torch.from_numpy(_draw(self, s.shape, init, default_init,
                                           rng)))
        self._initialized = True

    # ------------------------------------------------------------ access
    def data(self, ctx=None):
        """The value, an NDArray over the storage (no copy)."""
        return ndarray.NDArray(self._check(ctx))

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer, an NDArray over the storage's ``.grad``
        (no copy): zeros before the first backward."""
        s = self._check(ctx)
        if self.grad_req == "null":
            raise RuntimeError("Cannot get gradient of Parameter %s because "
                               "grad_req='null'" % self.name)
        if s.grad is None:
            s.grad = torch.zeros_like(s)
        return ndarray.NDArray(s.grad)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        s = self._storage
        if s is None:
            raise RuntimeError("Parameter %s has not been initialized"
                               % self.name)
        dev = getattr(s, "_pending_device", None) if is_deferred(s) else None
        return [context_of(dev or s.device)]

    def set_data(self, data):
        """Copy ``data`` (an NDArray, tensor or numpy array of the shape)
        into the storage in place; a deferred parameter takes its shape."""
        src = _as_tensor(data)
        s = self._storage
        if s is None:
            raise RuntimeError("Parameter %s has not been initialized"
                               % self.name)
        if is_deferred(s):
            s._pending_init = None
            materialize(s, src.shape)
        if tuple(src.shape) != tuple(s.shape):
            raise ValueError("shape mismatch for %s: %s vs %s"
                             % (self.name, tuple(src.shape), tuple(s.shape)))
        with torch.no_grad():
            s.copy_(src.detach())
        self._initialized = True

    def zero_grad(self):
        s = self._storage
        if s is not None and s.grad is not None:
            with torch.no_grad():
                s.grad.zero_()

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (its gradient is dropped)."""
        if self._storage is None:
            raise RuntimeError("Parameter %s has not been initialized"
                               % self.name)
        self._move(_one_device(ctx))

    def cast(self, dtype):
        """Cast the storage to ``dtype`` in place (its gradient is
        dropped)."""
        self._dtype = dtype
        s = self._storage
        if s is None:
            return
        dt = torch_dtype(dtype)
        if is_deferred(s):
            s._pending_dtype = dt
        elif s.dtype != dt:
            _bump_generation()
            s.data = s.data.to(dt)
            s.grad = None

    def var(self):
        """A ``mx.sym.Variable`` of this parameter, with its shape, dtype,
        ``lr_mult`` and ``wd_mult``."""
        from .. import symbol

        dt = self.dtype
        return symbol.Variable(
            self.name, shape=self.shape,
            dtype=dt if isinstance(dt, np.dtype) else None,
            lr_mult=self.lr_mult, wd_mult=self.wd_mult)


class _ConstantInit(_init.Initializer):
    """Fills an array with one fixed value."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    def _init_weight(self, arr, rng):
        arr[...] = self.value


class Constant(Parameter):
    """A non-trainable parameter of a fixed value (reference:
    ``gluon.Constant``)."""

    def __init__(self, name, value):
        if isinstance(value, ndarray.NDArray):
            value = value.asnumpy()
        elif isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        value = np.asarray(value, dtype=None if isinstance(
            value, np.ndarray) else np.float32)
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_ConstantInit(value),
                         differentiable=False)


class ParameterDict:
    """A prefix-scoped dictionary of :class:`Parameter` (reference:
    ``gluon.ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = "\n".join("  %r" % p for p in self._params.values())
        return "ParameterDict(prefix=%r\n%s\n)" % (self._prefix, s)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, made with ``kwargs`` if there
        is none (an existing one takes the attributes it lacks; a shape's
        0s are filled from ``shape``)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if k == "shape" and param.shape is not None and v is not None:
                v = tuple(v)
                if len(v) == len(param.shape):
                    param.shape = v
                    continue
            if getattr(param, k, None) in (None, v) or k == "init":
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        """The :class:`Constant` ``prefix + name``, made from ``value`` if
        there is none."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise ValueError("No constant named %s" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    "Cannot update self with other because they have "
                    "different Parameters with the same name %s" % k)
            self._params[k] = v

    # ------------------------------------------------------------ bulk ops
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize each parameter (see :meth:`Parameter.initialize`);
        ``init`` is the default initializer (``Uniform()``)."""
        del verbose
        for p in self.values():
            p.initialize(None, ctx, default_init=init or _init.Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def list_ctx(self):
        ctxs = []
        for p in self.values():
            for c in p.list_ctx():
                if c not in ctxs:
                    ctxs.append(c)
        return ctxs

    def setattr(self, name, value):
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) of every
        parameter."""
        for p in self.values():
            setattr(p, name, value)

    def cast(self, dtype):
        for p in self.values():
            p.cast(dtype)

    # ------------------------------------------------------------ save/load
    def save(self, filename, strip_prefix=""):
        """Write every parameter by name (``strip_prefix`` taken off) in the
        npz format both packages read."""
        arg_dict = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = p.data().as_in_context(cpu())
        ndarray.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Read a :meth:`save` file (names get ``restore_prefix``);
        ``IOError`` on a missing name unless ``allow_missing``, on an extra
        one unless ``ignore_extra``."""
        loaded = {restore_prefix + k: v
                  for k, v in ndarray.read_npz(filename).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise IOError("Parameter %s is missing in file %s"
                                  % (name, filename))
        for name, value in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError("Parameter %s loaded from %s is not present "
                                  "in this ParameterDict" % (name, filename))
                continue
            p = self._params[name]
            if p._storage is None:
                p.shape = tuple(value.shape)
                p._attach(_one_device(ctx) if ctx is not None
                          else resolve_device(None))
            p.set_data(value)
