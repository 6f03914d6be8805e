"""Gluon of the PyTorch port: blocks as ``torch.nn.Module``s."""

from . import nn
from .block import Block, HybridBlock

__all__ = ["Block", "HybridBlock", "nn"]
