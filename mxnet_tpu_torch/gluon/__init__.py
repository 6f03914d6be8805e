"""Gluon of the PyTorch port: blocks as ``torch.nn.Module``s, losses and
the Trainer."""

from . import loss, nn
from .block import Block, HybridBlock, Parameter
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "Trainer", "loss", "nn"]
