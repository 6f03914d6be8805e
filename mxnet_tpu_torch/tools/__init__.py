"""Command-line tools of the PyTorch port (``python -m
mxnet_tpu_torch.tools.im2rec``)."""
