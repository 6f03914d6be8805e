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
``mx.callback``, ``mx.model`` (with ``FeedForward``) and
``mx.lr_scheduler``, the Module family (``mx.mod.SequentialModule``,
``PythonModule``, ``PythonLossModule``), ``mx.monitor`` (``mx.mon``) and
custom operators (``mx.operator``, ``mx.sym.Custom``), and its recurrent
side: ``mx.rnn``'s cells and ``BucketSentenceIter`` trained through
``mx.mod.BucketingModule``.  The JAX package's top-level aliases are here
too (``mx.NDArray``, ``mx.Symbol``, ``mx.Module``, ``mx.Executor``,
``mx.DataIter``, ``mx.DataBatch``, ``mx.NameManager``,
``mx.save_checkpoint``, ``mx.load_checkpoint``, ``mx.do_checkpoint``,
``mx.Context``, ``mx.current_context``, ``mx.num_gpus``).  ``with
mx.cpu():`` makes the host the default device for the scope.  The
image-record data path is here too: ``mx.recordio``, ``mx.image`` (with
the detection augmenters and ``ImageDetIter``), ``mx.io.ImageRecordIter``
and a one-device ``mx.kv``; ``mx.tpu()`` is ``mx.gpu()``.
"""

from . import (attribute, autograd, callback, checkpoint, compiled_step,
               context, contrib, convert, executor, gluon, image,
               image_detection, initializer, io, kvstore, log, lr_scheduler,
               metric, model, module, monitor, name, ndarray, operator, ops,
               optimizer, parallel, predictor, random, recordio, rnn, rtc,
               serving, symbol, test_utils)
from . import initializer as init
from . import kvstore as kv
from . import module as mod
from . import monitor as mon
from . import ndarray as nd
from . import symbol as sym
from .attribute import AttrScope
from .base import MXNetError
from .callback import do_checkpoint
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, num_tpus, tpu)
from .executor import Executor
from .io import DataBatch, DataIter
from .model import load_checkpoint, save_checkpoint
from .module import Module
from .name import NameManager
from .ndarray import NDArray
from .symbol import Symbol

__all__ = ["AttrScope", "Context", "DataBatch", "DataIter", "Executor",
           "MXNetError",
           "Module", "NDArray", "NameManager", "Symbol", "attribute",
           "autograd", "callback", "checkpoint", "compiled_step", "context",
           "contrib", "convert", "cpu", "cpu_pinned", "current_context",
           "do_checkpoint", "executor", "gpu", "gluon", "image",
           "image_detection", "init", "initializer", "io", "kv", "kvstore",
           "load_checkpoint", "log", "lr_scheduler", "metric",
           "mod", "model", "module", "mon", "monitor", "name", "nd",
           "num_gpus", "num_tpus",
           "ndarray", "operator", "ops", "optimizer", "parallel", "predictor",
           "random", "recordio", "rnn", "rtc",
           "save_checkpoint", "serving", "sym", "symbol", "test_utils",
           "tpu"]
