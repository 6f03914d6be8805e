"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu, for one NVIDIA H100.

The JAX package ``mxnet_tpu`` is the reference; this package mirrors its
module names and API, imports ``torch`` and numpy and never JAX or
``mxnet_tpu``.  Entry points run on ``gpu(0)`` unless the caller passes a
device (``device="cpu"``), and raise :class:`MXNetError` when no CUDA device
is present.  The Pallas kernels of the reference become hand-written
Hopper kernels under ``csrc/``, built at first use (``_kernels``); the
run-time kernel facility (``rtc.CudaModule``) compiles a user's CUDA
source through NVRTC.  The three entry points of the JAX package are
here: imperative ``mx.nd``, Gluon, and the symbolic ``mx.sym`` ->
``Executor`` -> ``mx.mod.Module`` path with ``mx.io``, ``mx.metric``,
``mx.callback``, ``mx.model`` and ``mx.lr_scheduler``, and its recurrent
side: ``mx.rnn``'s cells and ``BucketSentenceIter`` trained through
``mx.mod.BucketingModule``.
"""

from . import (attribute, autograd, callback, context, convert, executor,
               gluon, initializer, io, lr_scheduler, metric, model, module,
               name, ndarray, ops, optimizer, parallel, random, rnn, rtc,
               serving, symbol)
from . import initializer as init
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .attribute import AttrScope
from .base import MXNetError
from .context import cpu, gpu

__all__ = ["AttrScope", "MXNetError", "attribute", "autograd", "callback",
           "context", "convert", "cpu", "executor", "gpu", "gluon", "init",
           "initializer", "io", "lr_scheduler", "metric", "mod", "model",
           "module", "name", "nd", "ndarray", "ops", "optimizer", "parallel",
           "random", "rnn", "rtc", "serving", "sym", "symbol"]
