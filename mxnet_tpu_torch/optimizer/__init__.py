"""Optimizers of the PyTorch port (counterpart of ``mxnet_tpu/optimizer``)."""

from .optimizer import (FTML, LBSGD, NAG, SGD, SGLD, AdaDelta, AdaGrad, Adam,
                        Adamax, DCASGD, Ftrl, Nadam, Optimizer, RMSProp,
                        Signum, Test, Updater, ccSGD, create, feed_active,
                        get_updater, register, scalar_feed)

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "Signum", "Adam", "Adamax",
           "Nadam", "FTML", "Ftrl", "RMSProp", "AdaGrad", "AdaDelta",
           "LBSGD", "DCASGD", "SGLD", "Test", "Updater", "register",
           "create", "get_updater", "scalar_feed", "feed_active"]
