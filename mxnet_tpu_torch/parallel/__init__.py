"""Training steps of the PyTorch port (counterpart of
``mxnet_tpu/parallel``): one device, no mesh."""

from .gluon_step import GluonTrainStep, sgd_momentum_update, zero_env_enabled

__all__ = ["GluonTrainStep", "sgd_momentum_update", "zero_env_enabled"]
