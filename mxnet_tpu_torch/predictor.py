"""Prediction-only API of the PyTorch port (the deployment surface).

Counterpart of ``mxnet_tpu/predictor.py`` (reference:
``include/mxnet/c_predict_api.h`` and ``amalgamation/python/
mxnet_predict.py``): a :class:`Predictor` binds an exported symbol (JSON)
and its saved parameters, and runs the forward pass through the port's
:class:`~mxnet_tpu_torch.executor.Executor`, whose predict forward is
one captured CUDA graph a bound executor on the card.  MXNet's
deployment path is ``save_checkpoint`` (or ``HybridBlock.export``) ->
``-symbol.json`` + ``.params`` -> ``Predictor`` -> ``InferenceServer``.

What differs from the JAX package:

- ``dev_type`` defaults to ``"gpu"`` (``gpu(dev_id)``, ``"tpu"`` its
  alias), as every port entry point runs on the card unless told
  otherwise; ``"cpu"`` is the CPU.  The JAX package's default is
  ``"cpu"``.
- The executor binds the loaded weight tensors themselves, so a
  :meth:`Predictor.reshape` or :meth:`Predictor._reshape_clone` shares
  their storage (MXPredReshape's sharing) instead of copying them.
- The forward rides no profiler span (the port has no profiler yet).
"""

from __future__ import annotations

import io
import time

import numpy as np

from . import histogram as _histogram
from . import runtime_stats as _rts
from .base import MXNetError

__all__ = ["Predictor", "load_ndarray_file"]


def load_ndarray_file(nd_bytes):
    """An ``mx.nd.save`` blob (bytes) as numpy arrays: a dict (name ->
    array) when it was saved from a dict, else a list."""
    from .ndarray.ndarray import _parse_npz

    with np.load(io.BytesIO(bytes(nd_bytes)), allow_pickle=False) as data:
        return _parse_npz(data)[1]


class Predictor:
    """Runs forward passes over an exported model.

    Parameters
    ----------
    symbol_json_str : str
        Contents of the ``*-symbol.json`` file (not a path).
    param_raw_bytes : bytes
        Contents of the ``*.params`` file (``arg:name``/``aux:name`` keys).
    input_shapes : dict of str to tuple
        Shapes of the input variables.
    dev_type : str, optional
        ``"gpu"`` (default; ``"tpu"`` an alias) or ``"cpu"``.
    dev_id : int, optional
    type_dict : dict of str to dtype, optional
        Input dtypes (default float32).
    """

    def __init__(self, symbol_json_str, param_raw_bytes, input_shapes,
                 dev_type="gpu", dev_id=0, type_dict=None):
        from . import context as _context
        from . import ndarray as _nd
        from . import symbol as _symbol

        self._symbol = _symbol.load_json(symbol_json_str)
        self._symbol_json = symbol_json_str
        self._dev_type, self._dev_id = dev_type, dev_id
        self._type_dict = dict(type_dict or {})
        if dev_type in ("gpu", "tpu"):
            self._ctx = _context.gpu(dev_id)
        elif dev_type == "cpu":
            self._ctx = _context.cpu()
        else:
            raise ValueError("dev_type must be 'gpu', 'tpu' or 'cpu', not %r"
                             % (dev_type,))
        params = load_ndarray_file(param_raw_bytes)
        if not isinstance(params, dict):
            raise ValueError("params blob must be a dict of arg:/aux: keys")
        # placed once; every bind (reshape, a server's bucket) binds these
        # tensors themselves
        self._arg_params = {k[4:]: _nd.array(v, ctx=self._ctx, dtype=v.dtype)
                            for k, v in params.items()
                            if k.startswith("arg:")}
        self._aux_params = {k[4:]: _nd.array(v, ctx=self._ctx, dtype=v.dtype)
                            for k, v in params.items()
                            if k.startswith("aux:")}
        self._bind(input_shapes)

    def _bind(self, input_shapes):
        if not isinstance(input_shapes, dict) or not all(
                isinstance(v, tuple) for v in input_shapes.values()):
            raise ValueError("Expect input_shapes to be dict str->tuple")
        unknown = set(input_shapes) - set(self._symbol.list_arguments())
        if unknown:
            raise ValueError("input_shapes names %s not in symbol arguments"
                             % sorted(unknown))
        self._input_names = sorted(input_shapes)
        arg_shapes, out_shapes, aux_shapes = self._symbol.infer_shape(
            **input_shapes)
        args = [self._bound(n, s, self._arg_params, self._type_dict)
                for n, s in zip(self._symbol.list_arguments(), arg_shapes)]
        aux = [self._bound(n, s, self._aux_params, {})
               for n, s in zip(self._symbol.list_auxiliary_states(),
                               aux_shapes)]
        self._exec = self._symbol.bind(self._ctx, args, grad_req="null",
                                       aux_states=aux)
        # fixed by the bound input shapes; computed once
        self._out_shapes = [tuple(s) for s in out_shapes]
        self._inputs = {}
        self._outputs = None

    def _bound(self, name, shape, loaded, types):
        """The array bound for ``name``: the loaded tensor itself, or
        zeros (an input, a label the forward does not read)."""
        from . import ndarray as _nd

        shape = tuple(shape)
        arr = loaded.get(name)
        if arr is None:
            return _nd.zeros(shape, ctx=self._ctx,
                             dtype=types.get(name, "float32"))
        if arr.shape != shape:
            raise MXNetError("parameter %r has shape %s, the symbol needs %s"
                             % (name, arr.shape, shape))
        return arr

    # ------------------------------------------------------------ running
    def forward(self, **kwargs):
        """Run forward with named inputs (numpy arrays); then
        ``get_output(i)``.  Feeds the ``predictor:forward`` histogram
        (when collection is on) and the ``predictor_forwards`` counter."""
        hist_on = _histogram._state["on"]
        if hist_on:
            t0 = time.perf_counter()
        self._forward_impl(**kwargs)
        _rts.inc("predictor_forwards")
        if hist_on:
            _histogram.observe("predictor:forward", time.perf_counter() - t0)
        return self

    def _forward_impl(self, **kwargs):
        for k, v in kwargs.items():
            if not isinstance(v, np.ndarray):
                raise ValueError("Expect numpy ndarray as input")
            if k not in self._input_names:
                raise ValueError("unknown input '%s' (expected %s)"
                                 % (k, self._input_names))
            dt = np.dtype(self._type_dict.get(k, np.float32))
            expect = tuple(self._exec.arg_dict[k].shape)
            v = np.asarray(v, dtype=dt, order="C")
            if tuple(v.shape) != expect:
                raise ValueError("input '%s' shape %s != bound shape %s "
                                 "(use reshape())" % (k, v.shape, expect))
            self._inputs[k] = v
        self._outputs = self._exec.forward(is_train=False, **self._inputs)

    def get_output(self, index):
        """The index-th output as a numpy array."""
        if self._outputs is None:
            raise RuntimeError("call forward() before get_output()")
        return self._outputs[index].asnumpy()

    @property
    def num_outputs(self):
        return len(self._symbol)

    def get_output_shape(self, index):
        return self._out_shapes[index]

    def get_input_names(self):
        return list(self._input_names)

    # ------------------------------------------------------------ reshape
    def reshape(self, input_shapes):
        """Rebind with new input shapes over the same weight tensors
        (reference: MXPredReshape)."""
        self._bind(input_shapes)
        return self

    def _reshape_clone(self, input_shapes):
        """A new predictor at new input shapes over the same weight
        tensors (the C ABI's reshape returns a fresh handle)."""
        new = Predictor.__new__(Predictor)
        new._symbol = self._symbol
        new._symbol_json = self._symbol_json
        new._dev_type, new._dev_id = self._dev_type, self._dev_id
        new._type_dict = dict(self._type_dict)
        new._ctx = self._ctx
        new._arg_params = self._arg_params
        new._aux_params = self._aux_params
        new._bind(input_shapes)
        return new
