"""Gluon contrib layers of the PyTorch port (reference:
python/mxnet/gluon/contrib/nn/basic_layers.py;
``mxnet_tpu/gluon/contrib/nn/__init__.py``): ``Concurrent``,
``HybridConcurrent``, ``Identity``, ``SyncBatchNorm`` and
``PixelShuffle1D``/``2D``/``3D``.

``HybridConcurrent``, ``Identity`` and ``SyncBatchNorm`` (a ``BatchNorm``
node) have the JAX package's Symbol path; ``Concurrent`` and the pixel
shuffles run on tensors and NDArrays only, as the JAX package has no
Symbol path for them either.  ``SparseEmbedding`` (row-sparse gradients)
is not ported."""

from __future__ import annotations

import torch

from ....ndarray.ndarray import NDArray, concatenate
from ...block import BoundOp, HybridBlock
from ...nn import BatchNorm, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SyncBatchNorm",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D"]


class Concurrent(Sequential):
    """The children run on the same input; their outputs concatenated
    along ``axis``."""

    _symbolic = False

    def __init__(self, axis=-1, prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._modules.values()]
        if isinstance(out[0], NDArray):
            return concatenate(out, axis=self.axis)
        return torch.cat(out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """:class:`Concurrent` that hybridizes; on a Symbol a ``Concat``
    node."""

    def __init__(self, axis=-1, prefix=None, params=None, *, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self.axis = axis
        self._concat = BoundOp("Concat", dim=axis)

    def hybrid_forward(self, F, x):
        return self._concat(F, *[block(x) for block in
                                 self._modules.values()])


class Identity(HybridBlock):
    """The input as it is."""

    _port_native = True
    _placeless = True

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x


class SyncBatchNorm(BatchNorm):
    """BatchNorm over axis 1 (reference: contrib/sync_batch_norm.cc:48)
    on one device: ``num_devices`` is taken and unused, as in the JAX
    package, whose statistics are global under its sharded step; on the
    card it runs K6a and K6b as :class:`~mxnet_tpu_torch.gluon.nn.
    BatchNorm` does."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", prefix=None,
                 params=None, *, device=None):
        del num_devices
        super().__init__(
            axis=1, momentum=momentum, epsilon=epsilon, center=center,
            scale=scale, use_global_stats=use_global_stats,
            beta_initializer=beta_initializer,
            gamma_initializer=gamma_initializer,
            running_mean_initializer=running_mean_initializer,
            running_variance_initializer=running_variance_initializer,
            in_channels=in_channels, prefix=prefix, params=params,
            device=device)


class _PixelShuffle(HybridBlock):
    """``(N, C * prod(f), *spatial)`` -> ``(N, C, *(s * f))``: each group
    of ``prod(factors)`` channels spread over the spatial axes."""

    _port_native = True
    _placeless = True
    _dims = 1

    def __init__(self, factor, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        try:
            self._factors = (int(factor),) * self._dims
        except TypeError:
            self._factors = tuple(int(f) for f in factor)
            if len(self._factors) != self._dims:
                raise ValueError("%s takes %d factors, not %s" % (
                    type(self).__name__, self._dims, factor))

    def forward(self, x):
        n, c, *spatial = x.shape
        d, f = self._dims, self._factors
        x = x.reshape(n, c // torch.Size(f).numel(), *f, *spatial)
        # (N, C, f1..fd, s1..sd) -> (N, C, s1, f1, ..., sd, fd)
        order = [0, 1] + [a for i in range(d) for a in (2 + d + i, 2 + i)]
        return x.permute(order).reshape(
            n, -1, *(s * k for s, k in zip(spatial, f)))

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__,
                           self._factors[0] if self._dims == 1
                           else self._factors)


class PixelShuffle1D(_PixelShuffle):
    """``(N, C*f, W)`` -> ``(N, C, W*f)``."""

    _dims = 1


class PixelShuffle2D(_PixelShuffle):
    """``(N, C*f1*f2, H, W)`` -> ``(N, C, H*f1, W*f2)``."""

    _dims = 2


class PixelShuffle3D(_PixelShuffle):
    """``(N, C*f1*f2*f3, D, H, W)`` -> ``(N, C, D*f1, H*f2, W*f3)``."""

    _dims = 3
