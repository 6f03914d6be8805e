"""Recurrent layers and cells of the PyTorch port (counterpart of
``mxnet_tpu/gluon/rnn``)."""

from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, HybridSequentialRNNCell, LSTMCell,
                       RecurrentCell, ResidualCell, RNNCell, SequentialRNNCell,
                       ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "HybridRecurrentCell",
           "RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "HybridSequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]
