"""Gluon contrib recurrent cells of the PyTorch port (reference:
python/mxnet/gluon/contrib/rnn/; ``mxnet_tpu/gluon/contrib/rnn/``):
``LSTMPCell``, ``VariationalDropoutCell`` and the convolutional
``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``s, each with the JAX package's alias,
parameters and Symbol path (a step on Symbols)."""

from .conv_rnn_cell import (Conv1DGRUCell, Conv1DLSTMCell, Conv1DRNNCell,
                            Conv2DGRUCell, Conv2DLSTMCell, Conv2DRNNCell,
                            Conv3DGRUCell, Conv3DLSTMCell, Conv3DRNNCell)
from .rnn_cell import LSTMPCell, VariationalDropoutCell

__all__ = ["LSTMPCell", "VariationalDropoutCell",
           "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]
