"""``mx.mod``: the Module API of the PyTorch port (counterpart of
``mxnet_tpu/module``): ``BaseModule``, ``Module`` on one device,
``BucketingModule``, ``SequentialModule``, and ``PythonModule`` and
``PythonLossModule``."""

from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule",
           "DataParallelExecutorGroup", "Module", "PythonLossModule",
           "PythonModule", "SequentialModule"]
