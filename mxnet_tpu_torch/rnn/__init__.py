"""``mx.rnn``: the symbolic recurrent cells, bucketed sentences and their
checkpoints (counterpart of ``mxnet_tpu/rnn``)."""

from .io import BucketSentenceIter, encode_sentences
from .rnn import (do_rnn_checkpoint, load_rnn_checkpoint, rnn_unroll,
                  save_rnn_checkpoint)
from .rnn_cell import (BaseConvRNNCell, BaseRNNCell, BidirectionalCell,
                       ConvGRUCell, ConvLSTMCell, ConvRNNCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       RNNCell, RNNParams, ResidualCell, SequentialRNNCell,
                       ZoneoutCell)

__all__ = ["BaseConvRNNCell", "BaseRNNCell", "BidirectionalCell",
           "BucketSentenceIter", "ConvGRUCell", "ConvLSTMCell",
           "ConvRNNCell", "DropoutCell", "FusedRNNCell", "GRUCell",
           "LSTMCell", "ModifierCell", "RNNCell", "RNNParams",
           "ResidualCell", "SequentialRNNCell", "ZoneoutCell",
           "do_rnn_checkpoint", "encode_sentences", "load_rnn_checkpoint",
           "rnn_unroll", "save_rnn_checkpoint"]
