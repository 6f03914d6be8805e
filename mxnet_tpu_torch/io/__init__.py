"""``mx.io``: data iterators of the PyTorch port (counterpart of
``mxnet_tpu/io``)."""

from .io import (CSVIter, DataBatch, DataDesc, DataIter, MNISTIter,
                 NDArrayIter, PrefetchingIter, ResizeIter)

__all__ = ["CSVIter", "DataBatch", "DataDesc", "DataIter", "MNISTIter",
           "NDArrayIter", "PrefetchingIter", "ResizeIter"]
