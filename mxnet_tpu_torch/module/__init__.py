"""``mx.mod``: the Module API of the PyTorch port (counterpart of
``mxnet_tpu/module``): ``BaseModule`` and ``Module`` on one device.
``BucketingModule``, ``SequentialModule`` and ``PythonModule`` are not
ported yet."""

from .base_module import BaseModule, BatchEndParam
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "DataParallelExecutorGroup",
           "Module"]
