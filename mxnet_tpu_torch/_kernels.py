"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, ``_build/<hash>/lib<name>.so``
(the hash covers the sources and the flags, so an edited source builds
anew), and loaded with ``ctypes``.  The build happens at first use, or up
front through :func:`build_all`; one ``nvcc`` runs for each source, all
started together.  A missing ``nvcc`` or a failed build raises
:class:`MXNetError`; nothing falls back.

Nothing here runs at import time: the module imports on machines with no
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError

__all__ = ["build_all", "library", "build_log", "CSRC", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported functions, by library
_SIGNATURES = {
    "flash_attn_fwd": {
        "mxt_flash_attn_fwd": (ctypes.c_int, [ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 4
                               + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]),
        "mxt_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "flash_attn_bwd": {
        "mxt_flash_attn_bwd_dq": (ctypes.c_int, [ctypes.c_void_p] * 7
                                  + [ctypes.c_int] * 4
                                  + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]),
        "mxt_flash_attn_bwd_dkv": (ctypes.c_int, [ctypes.c_void_p] * 8
                                   + [ctypes.c_int] * 4
                                   + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]),
        "mxt_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_lock = threading.Lock()
_libs: dict = {}
_logs: dict = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise MXNetError("nvcc not found: the port's CUDA kernels are built "
                         "from mxnet_tpu_torch/csrc at first use and need "
                         "the CUDA toolkit")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _build_dir(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _load(name, so_path):
    lib = ctypes.CDLL(so_path)
    for fn, (restype, argtypes) in _SIGNATURES.get(name, {}).items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def _build_locked(names=None):
    sources = _sources()
    out_dir = _build_dir(sources)
    os.makedirs(out_dir, exist_ok=True)
    todo = []
    for src in sources:
        name = os.path.splitext(os.path.basename(src))[0]
        if (names is not None and name not in names) or name in _libs:
            continue
        todo.append((name, src, os.path.join(out_dir, "lib%s.so" % name)))
    procs = []
    for name, src, so in todo:
        if os.path.exists(so):
            continue
        tmp = "%s.tmp%d" % (so, os.getpid())
        procs.append((name, so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        _logs[name] = log
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode,
                                                      log))
            continue
        os.replace(tmp, so)
    if failed:
        raise MXNetError("building the CUDA kernels failed: "
                         + "\n".join(failed))
    for name, _src, so in todo:
        _libs[name] = _load(name, so)


def build_all():
    """Build (or find built) and load every kernel library; returns the
    names built or loaded."""
    with _lock:
        _build_locked()
        return sorted(_libs)


def library(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built at first
    use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                _build_locked({name})
            lib = _libs.get(name)
        if lib is None:
            raise MXNetError("no kernel source csrc/%s.cu" % name)
    return lib


def build_log(name):
    """What ``nvcc -Xptxas -v`` printed for ``name`` in this process
    (registers, shared memory and spills of each kernel), or ``None``
    when the library was already built."""
    return _logs.get(name)
