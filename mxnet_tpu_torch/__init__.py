"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu, for one NVIDIA H100.

The JAX package ``mxnet_tpu`` is the reference; this package mirrors its
module names and API, imports ``torch`` and numpy and never JAX or
``mxnet_tpu``.  Entry points run on ``gpu(0)`` unless the caller passes a
device (``device="cpu"``), and raise :class:`MXNetError` when no CUDA device
is present.  The Pallas kernels of the reference become hand-written
Hopper kernels under ``csrc/``, built at first use (``_kernels``); the
run-time kernel facility (``rtc.CudaModule``) compiles a user's CUDA
source through NVRTC.
"""

from . import (autograd, context, convert, gluon, initializer, ndarray, ops,
               optimizer, parallel, random, rtc, serving)
from . import ndarray as nd
from .base import MXNetError
from .context import cpu, gpu

__all__ = ["MXNetError", "autograd", "context", "convert", "cpu", "gpu",
           "gluon", "initializer", "nd", "ndarray", "ops", "optimizer",
           "parallel", "random", "rtc", "serving"]
