"""Layers of the PyTorch port."""

from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           HybridSequential, LayerNorm, Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell,
                          TransformerLM)

__all__ = ["Activation", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
           "Conv3D", "Conv3DTranspose", "Dense", "Dropout", "Embedding",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "HybridSequential", "LayerNorm", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "MultiHeadAttention", "PositionwiseFFN",
           "ReflectionPad2D", "Sequential", "TransformerEncoder",
           "TransformerEncoderCell", "TransformerLM"]
