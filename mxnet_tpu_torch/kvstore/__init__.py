"""``mx.kv``: the KVStore of the PyTorch port, on one device.

Counterpart of ``mxnet_tpu/kvstore/`` (reference: include/mxnet/kvstore.h,
src/kvstore/kvstore_local.h).  Multi-GPU stores wait for ROADMAP Queue 1
item 9.
"""

from .gradient_compression import GradientCompression
from .kvstore import KVStore, create

__all__ = ["GradientCompression", "KVStore", "create"]
