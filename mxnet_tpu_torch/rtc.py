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

A launch costs what the driver costs.  :meth:`CudaModule.get_kernel`
builds the kernel's :func:`launch_template` once: an argument block with
each argument at its C type's offset and alignment, one ``struct.Struct``
that packs the scalars and the data pointers into it, and a ``void*[]``
into the block (one block for each thread: ``cuLaunchKernel`` copies the
arguments at the call).  A launch checks each argument with attribute
reads, packs the block with one call and calls ``cuLaunchKernel`` on the
raw current stream; its messages are formatted only when it raises, by
the same checks in the same order (kind, dtype and layout first, then the
device).  The device and the function are looked up once for each
``ctx`` value.  A launch on a stream that a CUDA graph is capturing is
captured, as every other kernel of the port is.

``PallasModule`` (Pallas kernels for a TPU) does not exist on a CUDA card
and raises, naming ``CudaModule``, as the JAX package's ``CudaModule``
raises naming ``PallasModule``.
"""

from __future__ import annotations

import ctypes
import operator
import re
import struct
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import _nvrtc
from .base import MXNetError, numeric_types
from .context import resolve_device
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "parse_signature",
           "launch_template", "LaunchTemplate"]

# MXNet's C types: (torch dtype of an array, numpy dtype of a scalar, the
# scalar's struct code in the argument block); a __half scalar travels as
# its 16 bits
_C_TYPES = {
    "float": (torch.float32, np.float32, "f"),
    "double": (torch.float64, np.float64, "d"),
    "__half": (torch.float16, np.float16, "e"),
    "uint8_t": (torch.uint8, np.uint8, "B"),
    "int": (torch.int32, np.int32, "i"),
    "int32_t": (torch.int32, np.int32, "i"),
    "int8_t": (torch.int8, np.int8, "b"),
    "char": (torch.int8, np.int8, "b"),
    "int64_t": (torch.int64, np.int64, "q"),
}
_POINTER = "Q"  # a data pointer: 8 bytes, 8-aligned
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


class LaunchTemplate(NamedTuple):
    """The argument block of a kernel: ``offsets`` of each argument,
    ``size`` of the block and the little-endian ``struct`` ``format`` that
    packs it (explicit pad bytes, ``Q`` for a pointer)."""
    offsets: tuple
    size: int
    format: str


def launch_template(params):
    """The :class:`LaunchTemplate` of the parsed signature ``params``:
    each argument at its C type's offset and alignment (a pointer 8 bytes),
    as a C struct of the same members lays them out, the block padded to
    its largest alignment.  A pure function of the signature."""
    fmt, offsets, off, align = ["<"], [], 0, 1
    for is_ptr, _const, ctype in params:
        code = _POINTER if is_ptr else _C_TYPES[ctype][2]
        size = struct.calcsize(code)  # each of these types' alignment
        pad = -off % size
        if pad:
            fmt.append("%dx" % pad)
        offsets.append(off + pad)
        off += pad + size
        fmt.append(code)
        align = max(align, size)
    tail = -off % align
    if tail:
        fmt.append("%dx" % tail)
    return LaunchTemplate(tuple(offsets), off + tail, "".join(fmt))


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


def _checker(params):
    """A function ``(args, index) -> values or None`` that checks ``args``
    against the parsed signature ``params`` for a launch on device
    ``index`` (each array an NDArray of the C type's dtype, on the device,
    contiguous; each scalar a number) and returns the argument block's
    values (data pointers and scalars), or None when a check fails.  It is
    written out for the signature, one statement an argument, since a loop
    over the arguments took twice its time."""
    names = ["a%d" % i for i in range(len(params))]
    lines = ["def check(args, index):",
             "    if len(args) != %d:" % len(params),
             "        return None",
             "    %s, = args" % ", ".join(names)]
    env = {"NDArray": NDArray, "numbers": numeric_types}
    out = []
    for i, (is_ptr, _const, ctype) in enumerate(params):
        a = names[i]
        if is_ptr:
            env["dtype%d" % i] = _C_TYPES[ctype][0]
            lines += ["    if not isinstance(%s, NDArray):" % a,
                      "        return None",
                      "    t%d = %s.data_torch" % (i, a),
                      "    if t%d.dtype is not dtype%d or t%d.get_device() != "
                      "index or not t%d.is_contiguous():" % (i, i, i, i),
                      "        return None"]
            out.append("t%d.data_ptr()" % i)
        else:
            lines += ["    if not isinstance(%s, numbers):" % a,
                      "        return None"]
            out.append(a)
    lines.append("    return (%s,)" % ", ".join(out))
    exec("\n".join(lines), env)  # noqa: S102 - generated from the signature
    return env["check"]


class _Block(threading.local):
    """One thread's argument block of a kernel and the ``void*[]`` into it
    (``cuLaunchKernel`` copies the arguments, so the block is free again
    when the call returns)."""

    def __init__(self, template):
        self.buf = ctypes.create_string_buffer(max(template.size, 1))
        base = ctypes.addressof(self.buf)
        n = max(len(template.offsets), 1)
        self.ptrs = (ctypes.c_void_p * n)(
            *[base + off for off in template.offsets])


class CudaKernel:
    """A kernel of a :class:`CudaModule`, launched with
    :meth:`launch`.  ``CudaKernel.launches`` counts every launch."""

    launches = 0

    def __init__(self, module, symbol, name, params):
        self._module = module
        self._symbol = symbol
        self.name = name
        self._params = params
        self.template = launch_template(params)
        self._packer = struct.Struct(self.template.format)
        self._values = _checker(params)
        self._block = _Block(self.template)
        self._resolved = {}  # ctx -> (device index, CUfunction)

    def _raise_for(self, args, dev):
        """Raise the :class:`MXNetError` of the first argument that fails
        its checks: kind, dtype and layout of each in order first, then
        the device of every array."""
        if len(args) != len(self._params):
            raise MXNetError("CudaKernel(%s) expects %d arguments but got %d"
                             % (self.name, len(self._params), len(args)))
        arrays = []
        for i, (arg, (is_ptr, _const, ctype)) in enumerate(zip(args,
                                                             self._params)):
            tdt = _C_TYPES[ctype][0]
            what = "CudaKernel(%s): argument %d (%s%s)" % (
                self.name, i, ctype, " *" if is_ptr else "")
            if not is_ptr:
                if not isinstance(arg, numeric_types):
                    raise MXNetError("%s must be a number, got %s"
                                     % (what, type(arg).__name__))
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
        for what, t in arrays:
            if t.device != dev:
                raise MXNetError("%s lies on %s, the launch is on %s"
                                 % (what, t.device, dev))

    def _pack(self, values):
        """Pack ``values`` into this thread's argument block; a scalar that
        the struct code refuses (a float for an integer, a value out of
        the type's range) is cast as numpy casts it."""
        buf = self._block.buf
        try:
            self._packer.pack_into(buf, 0, *values)
        except (struct.error, OverflowError):
            self._packer.pack_into(buf, 0, *[
                v if is_ptr else np.array(v, _C_TYPES[t][1]).item()
                for v, (is_ptr, _c, t) in zip(values, self._params)])
        return self._block.ptrs

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on the card ``ctx`` with ``grid_dims`` blocks of
        ``block_dims`` threads (3 ints each) and ``shared_mem`` bytes of
        dynamic shared memory, on the device's current stream; returns at
        once (the stream orders it)."""
        try:
            index, func = self._resolved[ctx]
            gx, gy, gz = grid_dims
            bx, by, bz = block_dims
        except (KeyError, TypeError, ValueError):
            return self._launch_checked(args, ctx, grid_dims, block_dims,
                                        shared_mem)
        values = self._values(args, index)
        if values is None \
                or not type(gx) is type(gy) is type(gz) is type(bx) \
                is type(by) is type(bz) is int \
                or gx < 1 or gy < 1 or gz < 1 or bx < 1 or by < 1 \
                or bz < 1 or bx * by * bz > MAX_THREADS_PER_BLOCK:
            return self._launch_checked(args, ctx, grid_dims, block_dims,
                                        shared_mem)
        _nvrtc.launch(func, index, grid_dims, block_dims, shared_mem,
                      _nvrtc.current_stream(index), self._pack(values))
        CudaKernel.launches += 1

    def _launch_checked(self, args, ctx, grid_dims, block_dims, shared_mem):
        """The launch with every check in order, raising the first that
        fails; after a launch the device and function of ``ctx`` are kept
        for the next."""
        dev = torch.device(ctx) if not isinstance(ctx, torch.device) else ctx
        if dev.type != "cuda":
            raise MXNetError("CudaKernel(%s) can only be launched on a GPU "
                             "context, got %s" % (self.name, dev))
        explicit = dev.index is not None
        dev = resolve_device(dev)
        grid, block = tuple(grid_dims), tuple(block_dims)
        try:
            if len(grid) != 3 or len(block) != 3:
                raise TypeError
            grid = tuple(operator.index(d) for d in grid)
            block = tuple(operator.index(d) for d in block)
        except TypeError:
            raise MXNetError("grid_dims and block_dims must be 3 integers "
                             "each, got %s and %s" % (grid, block)) from None
        if min(grid + block) < 1:
            raise MXNetError("grid_dims and block_dims must be positive, "
                             "got %s and %s" % (grid, block))
        threads = block[0] * block[1] * block[2]
        if threads > MAX_THREADS_PER_BLOCK:
            raise MXNetError("CudaKernel(%s): %d threads a block, more than "
                             "the card's %d" % (self.name, threads,
                                               MAX_THREADS_PER_BLOCK))
        values = self._values(args, dev.index)
        if values is None:
            self._raise_for(args, dev)
            raise MXNetError("CudaKernel(%s): an argument failed its checks"
                             % self.name)
        func = self._module._function(dev.index, self._symbol)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _nvrtc.launch(func, dev.index, grid, block, shared_mem, stream,
                      self._pack(values))
        CudaKernel.launches += 1
        if explicit:  # "cuda" alone follows the current device
            try:
                self._resolved[ctx] = (dev.index, func)
            except TypeError:  # an unhashable ctx is resolved every time
                pass


class PallasModule:
    """Not available on a CUDA card (the JAX package's TPU facility)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "PallasModule (Pallas kernels for a TPU) is not available on a "
            "CUDA card. Use mx.rtc.CudaModule to compile a CUDA kernel at "
            "run time through NVRTC instead.")
