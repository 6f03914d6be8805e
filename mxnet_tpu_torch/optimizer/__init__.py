"""Optimizers of the PyTorch port (counterpart of ``mxnet_tpu/optimizer``)."""

from .optimizer import (SGD, Adam, Optimizer, Updater, create, feed_active,
                        get_updater, register, scalar_feed)

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "register", "create",
           "get_updater", "scalar_feed", "feed_active"]
