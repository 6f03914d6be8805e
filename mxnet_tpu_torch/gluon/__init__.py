"""Gluon of the PyTorch port: blocks as ``torch.nn.Module``s, losses, the
Trainer and the model zoo."""

from . import loss, model_zoo, nn
from .block import Block, HybridBlock, Parameter
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "Trainer", "loss",
           "model_zoo", "nn"]
