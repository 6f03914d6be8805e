"""Gluon of the PyTorch port: blocks as ``torch.nn.Module``s with the
reference's parameters, names and ``hybrid_forward``; losses, the
Trainer, the recurrent layers and cells, the data API, the utilities, the
model zoo and contrib."""

from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from .utils import split_and_load

__all__ = ["Block", "Constant", "DeferredInitializationError",
           "HybridBlock", "Parameter", "ParameterDict", "SymbolBlock",
           "Trainer", "contrib", "data", "loss", "model_zoo", "nn", "rnn",
           "split_and_load", "utils"]
