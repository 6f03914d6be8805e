"""Parameter initializers of the PyTorch port.

Counterpart of ``mxnet_tpu/initializer.py`` (reference:
python/mxnet/initializer.py): the registry (``register``, ``create``,
also from ``dumps()``), ``InitDesc``, and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Xavier``, ``Orthogonal``,
``MSRAPrelu``, ``Bilinear``, ``Mixed``, ``Load``, and the recurrent cells'
``LSTMBias`` and ``FusedRNN``.  An initializer
dispatches on the parameter name's suffix as the JAX package does:
``weight`` draws from the initializer; ``bias``, ``beta`` and the
moving or running means are zeros; ``gamma`` and the moving or running
variances ones; a name's ``__init__`` attribute (an initializer's
``dumps()``) takes precedence.

An initializer is called two ways: by Gluon as ``init(name, arr, rng)``
on a numpy array with a ``numpy.random.RandomState``, and by the Module
API as ``init(desc, arr)`` on an NDArray, filled from a numpy array drawn
from :func:`mxnet_tpu_torch.random.host_rng` (restarted by
``random.seed``).  The draws cannot match the JAX package's key-based
ones: tests hold the laws.
"""

from __future__ import annotations

import json
import re

import numpy as np

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "Orthogonal", "MSRAPrelu", "Bilinear",
           "Mixed", "Load", "LSTMBias", "FusedRNN", "register", "create"]

_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one"}


class InitDesc(str):
    """A parameter's name with its attributes (reference: InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def register(klass):
    """Register an initializer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    """``init`` itself if it is an :class:`Initializer`, else the
    registered initializer of that name (``'xavier'``, ``'zeros'``, ...)
    or of that ``dumps()`` string."""
    if isinstance(init, Initializer):
        return init
    name = str(init)
    if name.startswith("["):
        name, kwargs = json.loads(name)
    cls = _REGISTRY.get(_ALIASES.get(name.lower(), name.lower()))
    if cls is None:
        raise ValueError("unknown initializer %r; the port has %s"
                         % (init, ", ".join(sorted(_REGISTRY))))
    return cls(**kwargs)


class Initializer:
    """Fills a named parameter, by its name's suffix."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        """Keep MXNet's verbosity switch and printer (the JAX package's
        ``initializer.py:39``: stored, and printing nothing)."""
        self._verbose = verbose
        self._print_func = print_func
        return self

    def dumps(self):
        """``[name, kwargs]`` as JSON; :func:`create` reads it back."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, rng=None):
        if not isinstance(desc, str):
            raise TypeError("desc must be a str or an InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        if isinstance(arr, np.ndarray):
            self._fill(desc, arr, rng if rng is not None else _host_rng())
            return
        buf = np.zeros(arr.shape, dtype=np.float32)
        self._fill(desc, buf, rng if rng is not None else _host_rng())
        arr[:] = buf

    def _fill(self, desc, arr, rng):
        own = getattr(desc, "attrs", {}).get("__init__")
        if own:
            create(own)._init_named(desc, arr, rng)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(arr, rng)
        elif name.endswith(("bias", "beta", "running_mean", "moving_mean",
                            "moving_inv_var", "moving_avg")):
            arr[...] = 0.0
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr[...] = 1.0
        else:
            raise ValueError("Unknown initialization pattern for %s; name a "
                             "known suffix (weight/bias/gamma/beta/"
                             "running_mean/running_var/moving_mean/"
                             "moving_var) or set an explicit init" % name)

    def _init_named(self, desc, arr, rng):
        """Fill ``arr`` as the ``__init__`` attribute of ``desc`` asks."""
        del desc
        self._init_weight(arr, rng)

    def _init_weight(self, arr, rng):
        raise NotImplementedError()


def _host_rng():
    from .random import host_rng

    return host_rng()


@register
class Zero(Initializer):
    """Zeros (also ``'zeros'``)."""

    def _init_weight(self, arr, rng):
        arr[...] = 0.0


@register
class One(Initializer):
    """Ones (also ``'ones'``)."""

    def _init_weight(self, arr, rng):
        arr[...] = 1.0


@register
class Constant(Initializer):
    """Every weight ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, arr, rng):
        arr[...] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale), the framework default (scale 0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, arr, rng):
        arr[...] = rng.uniform(-self.scale, self.scale, size=arr.shape)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, arr, rng):
        arr[...] = rng.normal(0.0, self.sigma, size=arr.shape)


@register
class Xavier(Initializer):
    """Xavier/Glorot (reference: initializer.py Xavier): scale
    ``sqrt(magnitude / factor)``, the factor the average of the fans
    (``'avg'``), the fan in or the fan out, each fan a dimension times
    the product of the dimensions past the second; uniform in
    ``[-scale, scale]`` or gaussian of that deviation."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, arr, rng):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim >= 2 (got %s)" % (shape,))
        hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[...] = rng.uniform(-scale, scale, size=shape)
        else:
            arr[...] = rng.normal(0.0, scale, size=shape)


@register
class Orthogonal(Initializer):
    """A (scaled) orthogonal matrix (reference: initializer.py Orthogonal,
    after Saxe et al.): the weight seen as (out, prod(rest)), the factor
    of the SVD of a draw (uniform in [-1, 1] or standard normal) of that
    shape whose shape it has, times ``scale``: its rows orthonormal when
    out <= in, its columns otherwise."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, arr, rng):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = rng.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[...] = (self.scale * q).reshape(arr.shape)


@register
class MSRAPrelu(Xavier):
    """He et al.'s initializer for PReLU nets (reference: initializer.py
    MSRAPrelu): gaussian Xavier of magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel for a transposed convolution's weight
    (reference: initializer.py Bilinear): entry (y, x) of every (out, in)
    plane is ``(1 - |x/f - c|) (1 - |y/f - c|)``, ``f = ceil(W / 2)``,
    ``c = (2f - 1 - f % 2) / 2f``."""

    def _init_weight(self, arr, rng):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        arr[...] = w.astype(np.float32).reshape(shape)


class Mixed(Initializer):
    """The initializer of the first of ``patterns`` (regexes) that matches
    a parameter's name (reference: initializer.py Mixed); no match
    raises ``ValueError``."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must pair up")
        super().__init__()
        self.map = list(zip([re.compile(p) for p in patterns],
                            [create(i) for i in initializers]))

    def __call__(self, desc, arr, rng=None):
        for prog, init in self.map:
            if prog.match(desc):
                init(desc, arr, rng)
                return
        raise ValueError("Parameter %s did not match any pattern" % desc)


class Load(Initializer):
    """Values by name from ``param`` (a dict of arrays; ``arg:``/``aux:``
    prefixes dropped), else ``default_init`` (reference: initializer.py
    Load); a name with neither raises ``ValueError``."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        self.param = {k.replace("arg:", "").replace("aux:", ""):
                      np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, desc, arr, rng=None):
        name = str(desc)
        if name in self.param:
            if self.param[name].shape != tuple(arr.shape):
                raise ValueError("shape mismatch loading %s: %s vs %s"
                                 % (name, self.param[name].shape,
                                    tuple(arr.shape)))
            arr[...] = self.param[name]
        elif self.default_init is None:
            raise ValueError("no init for %s" % name)
        else:
            create(self.default_init)(desc, arr, rng)


@register
class LSTMBias(Initializer):
    """An LSTM's i2h bias: 0, and ``forget_bias`` on the forget gate's
    quarter (gates i, f, c, o; reference: initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, arr, rng):
        h = arr.shape[0] // 4
        arr[...] = 0.0
        arr[h:2 * h] = self.forget_bias


@register
class FusedRNN(Initializer):
    """A ``FusedRNNCell``'s packed vector, piece by piece in the order of
    its per-gate names: each weight by ``init`` (or by the initializer
    that called this one, else ``Uniform(0.1)``), each bias 0, an LSTM's
    forget-gate biases ``forget_bias`` (reference: initializer.py
    FusedRNN)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(
            init=init.dumps() if init is not None else None,
            num_hidden=num_hidden, num_layers=num_layers, mode=mode,
            bidirectional=bidirectional, forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_named(self, desc, arr, rng):
        from .rnn.rnn_cell import FusedRNNCell

        cell = FusedRNNCell(self._num_hidden, self._num_layers, self._mode,
                            self._bidirectional,
                            forget_bias=self._forget_bias, prefix="")
        global_init = getattr(desc, "global_init", None)
        sub_init = self._init or global_init or Uniform(0.1)
        flat = arr.reshape(-1)
        for name, start, shape in cell.slices(flat.size):
            piece = flat[start:start + int(np.prod(shape))].reshape(shape)
            if self._mode == "lstm" and name.endswith("_f_bias"):
                piece[...] = self._forget_bias
                continue
            sub_init(InitDesc(name, global_init=global_init), piece, rng)

    def _init_weight(self, arr, rng):
        self._init_named("parameters", arr, rng)
