"""``mx.rtc``: compile a CUDA kernel at run time and launch it on NDArrays.

Counterpart of ``mxnet_tpu/rtc.py`` (K5: its ``PallasModule`` compiles a
user's Pallas kernel at run time, ``rtc.py:30-73``), with the API and
semantics of MXNet 1.5's ``python/mxnet/rtc.py`` (the C side is
``include/mxnet/rtc.h:39``):

    mod = CudaModule(source, options=(), exports=())
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    k.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))

The source is compiled by NVRTC (``_nvrtc``) to a CUBIN for ``sm_90a``
(``--gpu-architecture=sm_90a`` and ``-std=c++17`` are added unless the
options name their own), loaded into PyTorch's context of the launching
device and launched on its current stream.  ``extern "C"`` kernels are
found by name; a templated or namespaced kernel is named in ``exports``
(``"ns::scale<float>"``) and found through its lowered name.  Compiled
modules are cached in memory by source, options and device.

The signature is a C parameter list, ``(const) type (*) (name)`` per
argument; the types are MXNet's: float, double, __half, uint8_t, int,
int32_t, int8_t, char, int64_t.  A pointer argument must be an NDArray of
that dtype, contiguous, on the launch's device; a scalar is cast to the C
type.  :meth:`CudaKernel.launch` raises :class:`MXNetError` for a CPU
context or array, a wrong argument count, dtype or layout, and more than
1024 threads a block.  There is no CPU path: a kernel runs on the card or
not at all.

``PallasModule`` (Pallas kernels for a TPU) does not exist on a CUDA card
and raises, naming ``CudaModule``, as the JAX package's ``CudaModule``
raises naming ``PallasModule``.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from . import _nvrtc
from .base import MXNetError, numeric_types
from .context import resolve_device
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "parse_signature"]

# MXNet's C types: (torch dtype of an array, numpy dtype and ctypes type of
# a scalar); a __half scalar travels as its 16 bits
_C_TYPES = {
    "float": (torch.float32, np.float32, ctypes.c_float),
    "double": (torch.float64, np.float64, ctypes.c_double),
    "__half": (torch.float16, np.float16, ctypes.c_uint16),
    "uint8_t": (torch.uint8, np.uint8, ctypes.c_uint8),
    "int": (torch.int32, np.int32, ctypes.c_int32),
    "int32_t": (torch.int32, np.int32, ctypes.c_int32),
    "int8_t": (torch.int8, np.int8, ctypes.c_int8),
    "char": (torch.int8, np.int8, ctypes.c_int8),
    "int64_t": (torch.int64, np.int64, ctypes.c_int64),
}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")
MAX_THREADS_PER_BLOCK = 1024


def parse_signature(signature):
    """A C parameter list as ``[(is_pointer, is_const, c_type), ...]``.
    Raises ValueError for a malformed argument and TypeError for a type
    outside MXNet's list, as MXNet's ``get_kernel`` does."""
    out = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError('Invalid function prototype "%s". Must be in '
                             'the form of "(const) type (*) (name)"' % arg)
        if m.group(2) not in _C_TYPES:
            raise TypeError("Unsupported kernel argument type %s. Supported "
                            "types are: %s." % (arg, ",".join(_C_TYPES)))
        out.append((bool(m.group(3)), bool(m.group(1)), m.group(2)))
    return out


def _options(options):
    opts = [options] if isinstance(options, str) else list(options)
    if not any(o.startswith(("--gpu-architecture", "-arch")) for o in opts):
        opts.append("--gpu-architecture=sm_90a")
    if not any(o.startswith(("-std", "--std")) for o in opts):
        opts.append("-std=c++17")
    inc = _nvrtc.include_dir()
    if inc is not None:
        opts.append("--include-path=%s" % inc)
    return tuple(opts)


class CudaModule:
    """A CUDA C++ source compiled by NVRTC (reference: mx.rtc.CudaModule).

    ``options``: NVRTC options (a string or a sequence); ``exports``: the
    names of templated or namespaced kernels to look up, as written in C++.
    Compiles at construction; a compile error raises :class:`MXNetError`
    with NVRTC's log, which :attr:`log` keeps on success."""

    def __init__(self, source, options=(), exports=()):
        exports = [exports] if isinstance(exports, str) else list(exports)
        self._key, self._cubin, self._lowered, self.log = \
            _nvrtc.compile_cubin(source, _options(options), exports)
        self._funcs = {}  # (device, symbol) -> CUfunction

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name, or one of
        ``exports``) with C parameter list ``signature``."""
        return CudaKernel(self, self._lowered.get(name, name), name,
                          parse_signature(signature))

    def _function(self, device, symbol):
        func = self._funcs.get((device, symbol))
        if func is None:
            func = self._funcs[(device, symbol)] = _nvrtc.load_function(
                self._key, self._cubin, symbol, device)
        return func


class CudaKernel:
    """A kernel of a :class:`CudaModule`, launched with
    :meth:`launch`.  ``CudaKernel.launches`` counts every launch."""

    launches = 0

    def __init__(self, module, symbol, name, params):
        self._module = module
        self._symbol = symbol
        self.name = name
        self._params = params

    def _marshal(self, args, dev):
        """ctypes objects of ``args``; the checks of kind, dtype and layout
        come first, then the device of every array."""
        if len(args) != len(self._params):
            raise MXNetError("CudaKernel(%s) expects %d arguments but got %d"
                             % (self.name, len(self._params), len(args)))
        out, arrays = [], []
        for i, (arg, (is_ptr, _const, ctype)) in enumerate(zip(args,
                                                             self._params)):
            tdt, ndt, ct = _C_TYPES[ctype]
            what = "CudaKernel(%s): argument %d (%s%s)" % (
                self.name, i, ctype, " *" if is_ptr else "")
            if not is_ptr:
                if not isinstance(arg, numeric_types):
                    raise MXNetError("%s must be a number, got %s"
                                     % (what, type(arg).__name__))
                out.append(ct.from_buffer_copy(np.array(arg, ndt).tobytes()))
                continue
            if not isinstance(arg, NDArray):
                raise MXNetError("%s must be an NDArray, got %s"
                                 % (what, type(arg).__name__))
            t = arg.data_torch
            if t.dtype != tdt:
                raise MXNetError("%s must have dtype %s, got %s" % (
                    what, str(tdt).split(".")[1], str(t.dtype).split(".")[1]))
            if not t.is_contiguous():
                raise MXNetError("%s is not contiguous" % what)
            arrays.append((what, t))
            out.append(ctypes.c_void_p(t.data_ptr()))
        for what, t in arrays:
            if t.device != dev:
                raise MXNetError("%s lies on %s, the launch is on %s"
                                 % (what, t.device, dev))
        return out

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on the card ``ctx`` with ``grid_dims`` blocks of
        ``block_dims`` threads (3 ints each) and ``shared_mem`` bytes of
        dynamic shared memory, on the device's current stream; returns at
        once (the stream orders it)."""
        dev = torch.device(ctx) if not isinstance(ctx, torch.device) else ctx
        if dev.type != "cuda":
            raise MXNetError("CudaKernel(%s) can only be launched on a GPU "
                             "context, got %s" % (self.name, dev))
        dev = resolve_device(dev)
        grid, block = tuple(grid_dims), tuple(block_dims)
        if len(grid) != 3 or len(block) != 3:
            raise MXNetError("grid_dims and block_dims must be 3 integers "
                             "each, got %s and %s" % (grid, block))
        if min(grid + block) < 1:
            raise MXNetError("grid_dims and block_dims must be positive, "
                             "got %s and %s" % (grid, block))
        threads = block[0] * block[1] * block[2]
        if threads > MAX_THREADS_PER_BLOCK:
            raise MXNetError("CudaKernel(%s): %d threads a block, more than "
                             "the card's %d" % (self.name, threads,
                                               MAX_THREADS_PER_BLOCK))
        params = self._marshal(args, dev)
        func = self._module._function(dev.index, self._symbol)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _nvrtc.launch(func, dev.index, grid, block, shared_mem, stream,
                      params)
        CudaKernel.launches += 1


class PallasModule:
    """Not available on a CUDA card (the JAX package's TPU facility)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "PallasModule (Pallas kernels for a TPU) is not available on a "
            "CUDA card. Use mx.rtc.CudaModule to compile a CUDA kernel at "
            "run time through NVRTC instead.")
