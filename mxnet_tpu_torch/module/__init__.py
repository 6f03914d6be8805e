"""``mx.mod``: the Module API of the PyTorch port (counterpart of
``mxnet_tpu/module``): ``BaseModule``, ``Module`` on one device and
``BucketingModule``.  ``SequentialModule`` and ``PythonModule`` are not
ported yet."""

from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule",
           "DataParallelExecutorGroup", "Module"]
