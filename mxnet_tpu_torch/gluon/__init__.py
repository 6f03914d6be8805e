"""Gluon of the PyTorch port: blocks as ``torch.nn.Module``s, losses, the
Trainer, the recurrent layers and cells, the utilities and the model
zoo."""

from . import loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, Parameter
from .trainer import Trainer
from .utils import split_and_load

__all__ = ["Block", "HybridBlock", "Parameter", "Trainer", "loss",
           "model_zoo", "nn", "rnn", "split_and_load", "utils"]
