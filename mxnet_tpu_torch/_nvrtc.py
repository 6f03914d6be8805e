"""NVRTC and the CUDA driver API through ``ctypes``, for ``rtc.CudaModule``.

NVRTC (``libnvrtc``) compiles a CUDA C++ string to a CUBIN for
``sm_90a``; the driver API (``libcuda.so.1``) loads it into PyTorch's
primary context of a device and launches its kernels on PyTorch's current
stream.  ``libnvrtc`` is looked for beside the CUDA toolkit that
:func:`mxnet_tpu_torch._kernels._nvcc` finds, then in the ``nvidia``
wheels on ``sys.path`` and in torch's own ``lib``; its
``libnvrtc-builtins`` is loaded from the same directory first, since
NVRTC opens it by name.  A missing library, a failed compile or a
refused launch raises :class:`MXNetError`; nothing falls back.

Nothing loads at import time: the module imports on machines with no
CUDA at all.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import sys
import threading

from .base import MXNetError

__all__ = ["compile_cubin", "load_function", "launch", "current_stream",
           "nvrtc_version", "include_dir"]

_c = ctypes
_lock = threading.Lock()
_libs: dict = {}
_found: dict = {}      # "include" -> the include directory, or None
_compiled: dict = {}   # (source, options, exports) -> (cubin, lowered, log)
_modules: dict = {}    # (compile key, device) -> CUmodule
_contexts: dict = {}   # device -> CUcontext (primary, retained)
_smem_set: dict = {}   # CUfunction handle -> the dynamic shared memory set
_tls = threading.local()  # .cur: a CUcontext slot and a pointer to it
_raw_stream = None        # torch's raw current-stream getter, at first use
_calls = None             # (cuCtxGetCurrent, cuLaunchKernel) without argtypes

_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
STATIC_SHARED_LIMIT = 48 * 1024


def _toolkit_root():
    from ._kernels import _nvcc

    try:
        return os.path.dirname(os.path.dirname(os.path.realpath(_nvcc())))
    except MXNetError:
        return None


def _search_dirs():
    """Where ``libnvrtc`` is looked for, in order."""
    dirs = []
    root = _toolkit_root()
    if root is not None:
        dirs += [os.path.join(root, d) for d in
                 ("lib64", "lib", os.path.join("targets", "x86_64-linux",
                                               "lib"))]
    dirs += [os.path.join(p, "nvidia", "cuda_nvrtc", "lib") for p in sys.path
             if p]
    import torch

    dirs.append(os.path.join(os.path.dirname(torch.__file__), "lib"))
    return dirs


def include_dir():
    """The CUDA toolkit's include directory (for ``cuda_fp16.h`` and the
    like, which NVRTC does not carry), or None; looked up once."""
    if "include" not in _found:
        root = _toolkit_root()
        cands = [os.path.join(root, "include")] if root else []
        cands += [os.path.join(p, "nvidia", "cuda_runtime", "include")
                  for p in sys.path if p]
        _found["include"] = next((d for d in cands if os.path.exists(
            os.path.join(d, "cuda_fp16.h"))), None)
    return _found["include"]


def _proto(lib, name, restype, argtypes):
    f = getattr(lib, name)
    f.restype = restype
    f.argtypes = argtypes


def _nvrtc():
    lib = _libs.get("nvrtc")
    if lib is not None:
        return lib
    tried = _search_dirs()
    for d in tried:
        found = [p for p in sorted(glob.glob(os.path.join(d, "libnvrtc*.so*")))
                 if "builtins" not in os.path.basename(p)]
        if not found:
            continue
        for builtins in sorted(glob.glob(os.path.join(
                d, "libnvrtc-builtins*.so*"))):
            ctypes.CDLL(builtins, mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(found[0])
        break
    else:
        raise MXNetError("rtc.CudaModule needs NVRTC, and no libnvrtc was "
                         "found in: %s" % ", ".join(tried))
    vp, sz, cp = _c.c_void_p, _c.c_size_t, _c.c_char_p
    _proto(lib, "nvrtcVersion", _c.c_int, [_c.POINTER(_c.c_int)] * 2)
    _proto(lib, "nvrtcGetErrorString", cp, [_c.c_int])
    _proto(lib, "nvrtcCreateProgram", _c.c_int,
           [_c.POINTER(vp), cp, cp, _c.c_int, _c.POINTER(cp),
            _c.POINTER(cp)])
    _proto(lib, "nvrtcAddNameExpression", _c.c_int, [vp, cp])
    _proto(lib, "nvrtcCompileProgram", _c.c_int, [vp, _c.c_int,
                                                  _c.POINTER(cp)])
    _proto(lib, "nvrtcGetProgramLogSize", _c.c_int, [vp, _c.POINTER(sz)])
    _proto(lib, "nvrtcGetProgramLog", _c.c_int, [vp, _c.c_char_p])
    _proto(lib, "nvrtcGetCUBINSize", _c.c_int, [vp, _c.POINTER(sz)])
    _proto(lib, "nvrtcGetCUBIN", _c.c_int, [vp, _c.c_char_p])
    _proto(lib, "nvrtcGetLoweredName", _c.c_int, [vp, cp, _c.POINTER(cp)])
    _proto(lib, "nvrtcDestroyProgram", _c.c_int, [_c.POINTER(vp)])
    _libs["nvrtc"] = lib
    return lib


def _cuda():
    lib = _libs.get("cuda")
    if lib is not None:
        return lib
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise MXNetError("rtc: the CUDA driver (libcuda.so.1) cannot be "
                         "loaded: %s" % e) from e
    vp, u, i = _c.c_void_p, _c.c_uint, _c.c_int
    _proto(lib, "cuGetErrorString", i, [i, _c.POINTER(_c.c_char_p)])
    _proto(lib, "cuInit", i, [u])
    _proto(lib, "cuDeviceGet", i, [_c.POINTER(i), i])
    _proto(lib, "cuDevicePrimaryCtxRetain", i, [_c.POINTER(vp), i])
    _proto(lib, "cuCtxPushCurrent_v2", i, [vp])
    _proto(lib, "cuCtxPopCurrent_v2", i, [_c.POINTER(vp)])
    _proto(lib, "cuModuleLoadData", i, [_c.POINTER(vp), _c.c_char_p])
    _proto(lib, "cuModuleGetFunction", i, [_c.POINTER(vp), vp, _c.c_char_p])
    _proto(lib, "cuFuncSetAttribute", i, [vp, i, i])
    # the two calls of every launch, without argtypes: the launch passes
    # ctypes objects and ints, and the conversion of eleven arguments
    # through argtypes cost more than the rest of the call
    global _calls
    get_current, launch_kernel = lib["cuCtxGetCurrent"], lib["cuLaunchKernel"]
    get_current.restype = launch_kernel.restype = i
    _calls = get_current, launch_kernel
    _libs["cuda"] = lib
    return lib


def _check_nvrtc(lib, res, what):
    if res != 0:
        raise MXNetError("%s failed: %s" % (
            what, lib.nvrtcGetErrorString(res).decode()))


def _check_cu(res, what):
    if res != 0:
        msg = _c.c_char_p()
        _cuda().cuGetErrorString(res, _c.byref(msg))
        raise MXNetError("%s failed: CUDA error %d (%s)" % (
            what, res, msg.value.decode() if msg.value else "unknown"))


def nvrtc_version():
    lib = _nvrtc()
    major, minor = _c.c_int(), _c.c_int()
    _check_nvrtc(lib, lib.nvrtcVersion(_c.byref(major), _c.byref(minor)),
                 "nvrtcVersion")
    return major.value, minor.value


def _program_log(lib, prog):
    size = _c.c_size_t()
    lib.nvrtcGetProgramLogSize(prog, _c.byref(size))
    buf = _c.create_string_buffer(size.value)
    lib.nvrtcGetProgramLog(prog, buf)
    return buf.value.decode(errors="replace")


def _compile(source, options, exports):
    lib = _nvrtc()
    prog = _c.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        _c.byref(prog), source.encode(), b"rtc_module.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for name in exports:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, name.encode()),
                         "nvrtcAddNameExpression(%s)" % name)
        opts = [o.encode() for o in options]
        res = lib.nvrtcCompileProgram(prog, len(opts),
                                      (_c.c_char_p * len(opts))(*opts))
        log = _program_log(lib, prog)
        if res != 0:
            raise MXNetError("NVRTC could not compile the module (%s), "
                             "options %s:\n%s" % (
                                 lib.nvrtcGetErrorString(res).decode(),
                                 " ".join(options), log))
        size = _c.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, _c.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = _c.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            low = _c.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, name.encode(), _c.byref(low)),
                "nvrtcGetLoweredName(%s)" % name)
            lowered[name] = low.value.decode()
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(_c.byref(prog))


def compile_cubin(source, options, exports):
    """``(key, cubin, {export: lowered name}, log)`` of ``source`` compiled
    with ``options``; cached in memory by source, options and exports."""
    key = (source, tuple(options), tuple(exports))
    with _lock:
        hit = _compiled.get(key)
        if hit is None:
            hit = _compiled[key] = _compile(source, tuple(options),
                                            tuple(exports))
    return (key,) + hit


def _primary_context(device):
    ctx = _contexts.get(device)
    if ctx is None:
        cu = _cuda()
        _check_cu(cu.cuInit(0), "cuInit")
        dev = _c.c_int()
        _check_cu(cu.cuDeviceGet(_c.byref(dev), device), "cuDeviceGet")
        ctx = _c.c_void_p()
        _check_cu(cu.cuDevicePrimaryCtxRetain(_c.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _contexts[device] = ctx
    return ctx


@contextlib.contextmanager
def _current(device):
    """PyTorch's (primary) context of ``device``, current on this thread."""
    cu = _cuda()
    _check_cu(cu.cuCtxPushCurrent_v2(_primary_context(device)),
              "cuCtxPushCurrent")
    try:
        yield
    finally:
        cu.cuCtxPopCurrent_v2(_c.byref(_c.c_void_p()))


def load_function(key, cubin, name, device):
    """The ``CUfunction`` ``name`` of the module ``cubin`` (compile key
    ``key``) loaded on ``device``; modules are loaded once per device."""
    cu = _cuda()
    with _lock, _current(device):
        mod = _modules.get((key, device))
        if mod is None:
            mod = _c.c_void_p()
            _check_cu(cu.cuModuleLoadData(_c.byref(mod), cubin),
                      "cuModuleLoadData")
            _modules[(key, device)] = mod
        func = _c.c_void_p()
        _check_cu(cu.cuModuleGetFunction(_c.byref(func), mod, name.encode()),
                  "cuModuleGetFunction(%s)" % name)
    return func


def current_stream(device):
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``
    (the one ``torch.cuda.stream(...)`` set, or the capturing stream of a
    CUDA graph), without building a ``torch.cuda.Stream``: 0.1 us of host
    time on the H100's host against 4.1 us for
    ``torch.cuda.current_stream(device).cuda_stream``."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        _raw_stream = torch._C._cuda_getCurrentRawStream
    return _raw_stream(device)


def _launch_current(func, grid, block, shared_mem, stream, params):
    smem = int(shared_mem)
    if smem > STATIC_SHARED_LIMIT and _smem_set.get(func.value, 0) < smem:
        _check_cu(_cuda().cuFuncSetAttribute(
            func, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, smem),
            "cuFuncSetAttribute(max dynamic shared memory %d)" % smem)
        _smem_set[func.value] = smem
    res = _calls[1](func, int(grid[0]), int(grid[1]), int(grid[2]),
                    int(block[0]), int(block[1]), int(block[2]), smem,
                    _c.c_void_p(stream), params, None)
    if res != 0:
        _check_cu(res, "cuLaunchKernel")


def launch(func, device, grid, block, shared_mem, stream, params):
    """Launch ``func`` on ``stream`` of ``device``; ``params`` is the
    kernel's ``void*[]``, one pointer to each argument's value, alive for
    the call (the driver copies the values).  PyTorch's primary context of
    ``device`` is pushed unless ``cuCtxGetCurrent`` shows it current on
    this thread; the dynamic shared memory limit is raised once for
    each function and size."""
    if _calls is None:
        _cuda()
    cur = getattr(_tls, "cur", None)
    if cur is None:
        slot = _c.c_void_p()
        cur = _tls.cur = (slot, _c.pointer(slot))
    got = _calls[0](cur[1])
    primary = _contexts.get(device) or _primary_context(device)
    if got == 0 and cur[0].value == primary.value:
        _launch_current(func, grid, block, shared_mem, stream, params)
        return
    cu = _cuda()
    _check_cu(cu.cuCtxPushCurrent_v2(primary), "cuCtxPushCurrent")
    try:
        _launch_current(func, grid, block, shared_mem, stream, params)
    finally:
        cu.cuCtxPopCurrent_v2(_c.byref(_c.c_void_p()))
