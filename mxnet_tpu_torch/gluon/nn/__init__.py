"""Layers of the PyTorch port."""

from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           HybridSequential, LayerNorm, Sequential)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell,
                          TransformerLM)

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense",
           "Dropout", "Embedding", "GlobalAvgPool2D", "HybridSequential",
           "LayerNorm", "MaxPool2D", "MultiHeadAttention", "PositionwiseFFN",
           "Sequential",
           "TransformerEncoder", "TransformerEncoderCell", "TransformerLM"]
