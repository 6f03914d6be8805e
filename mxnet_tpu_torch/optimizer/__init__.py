"""Optimizers of the PyTorch port (counterpart of ``mxnet_tpu/optimizer``)."""

from .optimizer import (SGD, Adam, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "register", "create",
           "get_updater"]
