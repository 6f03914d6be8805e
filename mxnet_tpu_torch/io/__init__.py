"""``mx.io``: data iterators of the PyTorch port (counterpart of
``mxnet_tpu/io``)."""

from .io import (DataBatch, DataDesc, DataIter, MNISTIter, NDArrayIter,
                 ResizeIter)

__all__ = ["DataBatch", "DataDesc", "DataIter", "MNISTIter", "NDArrayIter",
           "ResizeIter"]
