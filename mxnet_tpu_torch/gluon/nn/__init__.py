"""Layers of the PyTorch port."""

from .basic_layers import Dense, Dropout, Embedding, HybridSequential, LayerNorm
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell,
                          TransformerLM)

__all__ = ["Dense", "Dropout", "Embedding", "HybridSequential", "LayerNorm",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderCell", "TransformerLM"]
