"""Neural-network ops of the PyTorch port, as plain functions on tensors.

Counterparts of ``mxnet_tpu/ops/nn.py`` Convolution, FullyConnected,
Activation, LeakyReLU (gelu), BatchNorm, LayerNorm, Pooling, Dropout,
log_softmax, the Module API's loss heads (SoftmaxOutput and the
regression outputs) and the CTC loss.  The JAX package leaves most of
these to XLA; here they stay plain PyTorch (matrix products go to
cuBLAS, the convolutions' forward and data-gradient and the max-pool
forward to cuDNN).  Two gradients are the
port's own kernels, as the JAX package routes them to Pallas: a
convolution's weight-gradient (:mod:`.conv_dw`, K1a/K1b) and a max pool's
input-gradient (:mod:`.pool_bwd`, K2).  BatchNorm, which XLA fuses inside
the JAX package's step, is the port's own forward and backward kernels
(:mod:`.batch_norm`, K6a/K6b).  On the card they always run; there is no
flag.

Convolution and pooling take channel-last data (NWC, NHWC or NDHWC)
and O+spatial+I weights.  They run cuDNN on the channel-last tensors
viewed as channel-first with ``channels_last`` strides, so nothing is
copied.  The registered ``Convolution`` and ``Pooling`` and the Gluon
layers also take the JAX ops' default layouts (``layout=None``,
``"NCW"``, ``"NCHW"`` or ``"NCDHW"``: channel-first data, OI+spatial
weights): they permute into the channel-last path and back
(:func:`nchw_call`), so the weight-gradient still runs K1 and the
max-pool backward K2.  A channel-first result is the channel-last
result's view, ``channels_last`` in memory, so the next layer's permute
is free and only a network's first input is copied.

Dimensions and groups.  A 2-D convolution of any ``num_group`` (a
depthwise one included) takes its weight-gradient from K1; a 1-D one runs
the 2-D path with a unit height, so K1 takes its weight-gradient too.  A
3-D convolution takes cuDNN's forward and data-gradient and
``aten.convolution_backward`` for its weight, the port's rule for work
the JAX package leaves to XLA (its Pallas dW gate takes ``nd == 2``
only, ``mxnet_tpu/ops/nn.py:79``).  ``Deconvolution`` (channel-first
only, as in the JAX package) is cuDNN's transposed convolution forward
and data-gradient; its weight-gradient is the convolution weight-gradient
of the output's gradient over the input at the same stride, pad,
dilation and groups, so its 1-D and 2-D forms launch K1 with the roles
swapped and its 3-D form takes aten's.  Pooling in 1-D runs the 2-D path
(K2 for the max backward); in 3-D aten's pools and their backward, as
XLA does it in the JAX package (``mxnet_tpu/ops/nn.py:617``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import autograd as _autograd
from .. import random as _random
from ..base import MXNetError
from .batch_norm import batch_norm
from .conv_dw import conv_dw
from .matrix import promote
from .pool_bwd import maxpool_bwd
from .registry import register

__all__ = ["convolution", "deconvolution", "fully_connected",
           "activation", "leaky_relu", "batch_norm", "layer_norm", "pooling",
           "dropout", "softmax", "log_softmax", "softmax_output",
           "regression_output", "l2_normalization", "nchw_call", "ctc_loss"]

# the layouts of 1-, 2- and 3-D data
CHANNEL_LAST = {1: "NWC", 2: "NHWC", 3: "NDHWC"}
CHANNEL_FIRST = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tup(v, n, what):
    """``v`` (an int or a sequence) as a tuple of ``n`` ints."""
    t = (int(v),) * n if isinstance(v, (int, np.integer)) \
        else tuple(int(a) for a in v)
    if len(t) != n:
        raise MXNetError("%s must have %d entries for a %d-D op, got %s"
                         % (what, n, n, v))
    return t


def _spatial(data, op):
    """The spatial dimensions of ``data``: 1, 2 or 3."""
    nd = data.dim() - 2
    if nd not in CHANNEL_LAST:
        raise MXNetError("%s: the port takes 1-D, 2-D or 3-D data, got %s"
                         % (op, tuple(data.shape)))
    return nd


def _last(t):
    """The channel-last view of a channel-first tensor."""
    return t.permute(0, *range(2, t.dim()), 1)


def _first(t):
    """The channel-first view of a channel-last tensor."""
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def _nchw(t):
    """The NCHW view (``channels_last`` strides) of an NHWC tensor."""
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    """The NHWC view of an NCHW tensor."""
    return t.permute(0, 2, 3, 1)


def _channel_first(layout):
    """True for the registered ops' channel-first layouts (None, the JAX
    ops' default, ``"NCW"``, ``"NCHW"`` or ``"NCDHW"``)."""
    return layout is None or layout in CHANNEL_FIRST.values()


def _check_channel_last(layout, nd, op):
    if layout != CHANNEL_LAST[nd]:
        raise MXNetError("%s: the port takes layout=%r here (channel-last "
                         "data, O%sI weights) for %d-D data; got %r"
                         % (op, CHANNEL_LAST[nd], CHANNEL_LAST[nd][1:-1],
                            nd, layout))


def _check_layout(layout, nd, op):
    """A ``nd``-D op's layout: its channel-last one or the channel-first
    default."""
    if layout not in (None, CHANNEL_FIRST[nd], CHANNEL_LAST[nd]):
        raise MXNetError("%s: the port takes layout %r (channel-first data, "
                         "OI%s weights) or %r (channel-last data, O%sI "
                         "weights); got %r"
                         % (op, CHANNEL_FIRST[nd], CHANNEL_FIRST[nd][2:],
                            CHANNEL_LAST[nd], CHANNEL_LAST[nd][1:-1],
                            layout))


def nchw_call(fn, data, *weights, layout, **kwargs):
    """``fn`` (a channel-last op) on ``data`` and ``weights`` in
    ``layout``: in the channel-first layouts each argument is seen as
    channel-last (O+spatial+I) and the result as channel-first again,
    both views (:func:`_last`, :func:`_first`)."""
    if not _channel_first(layout):
        return fn(data, *weights, layout=layout, **kwargs)
    nd = _spatial(data, getattr(fn, "__name__", "op"))
    if any(w.dim() != data.dim() for w in weights):
        raise MXNetError("the port takes %s data and OI%s weights, got %s"
                         % (CHANNEL_FIRST[nd], CHANNEL_FIRST[nd][2:],
                            [tuple(t.shape) for t in (data,) + weights]))
    return _first(fn(_last(data), *(_last(w) for w in weights),
                     layout=CHANNEL_LAST[nd], **kwargs))


class _Convolution(torch.autograd.Function):
    """NHWC/OHWI 2-D convolution of ``groups`` groups.  Forward and
    data-gradient are cuDNN's (``F.conv2d`` and
    ``aten.convolution_backward``) as the JAX package leaves them to XLA;
    the weight-gradient is :func:`~.conv_dw.conv_dw`, cast to the weight's
    dtype (``ops/nn.py:180-181`` of the JAX package), dilated, grouped or
    not."""

    @staticmethod
    def forward(ctx, x, weight, stride, pad, dilate, groups):
        out = F.conv2d(_nchw(x), _nchw(weight), None, stride, pad, dilate,
                       groups)
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.pad, ctx.dilate = stride, pad, dilate
        ctx.groups = groups
        return _nhwc(out)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        # the kernels take contiguous NHWC; autograd may hand a view
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _nhwc(torch.ops.aten.convolution_backward(
                _nchw(dy), _nchw(x), _nchw(weight), None, ctx.stride,
                ctx.pad, ctx.dilate, False, (0, 0), ctx.groups,
                (True, False, False))[0])
        if ctx.needs_input_grad[1]:
            dw = conv_dw(x.contiguous(), dy, weight.shape[1:3], ctx.stride,
                         ctx.pad, ctx.dilate, ctx.groups).to(weight.dtype)
        return dx, dw, None, None, None, None


class _Deconvolution(torch.autograd.Function):
    """2-D transposed convolution of NHWC ``x`` (N, H, W, I) with the
    reference's weight (I, O/G, KH, KW), output NHWC.  Forward and
    data-gradient are cuDNN's (``F.conv_transpose2d``, and the convolution
    of dy by the same weight); the weight-gradient is the convolution
    weight-gradient of dy over x at the same stride, pad, dilation and
    groups (the roles swapped: dy is that convolution's input, x its
    output), :func:`~.conv_dw.conv_dw` in (I, KH, KW, O/G), seen as
    (I, O/G, KH, KW)."""

    @staticmethod
    def forward(ctx, x, weight, stride, pad, dilate, adj, groups):
        out = F.conv_transpose2d(_nchw(x), weight, None, stride, pad, adj,
                                 groups, dilate)
        ctx.save_for_backward(x, weight)
        ctx.cfg = stride, pad, dilate, adj, groups
        return _nhwc(out)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, pad, dilate, adj, groups = ctx.cfg
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _nhwc(torch.ops.aten.convolution_backward(
                _nchw(dy), _nchw(x), weight, None, stride, pad, dilate,
                True, adj, groups, (True, False, False))[0])
        if ctx.needs_input_grad[1]:
            dw = conv_dw(dy, x.contiguous(), weight.shape[2:], stride, pad,
                         dilate, groups).permute(0, 3, 1, 2).to(weight.dtype)
        return dx, dw, None, None, None, None, None


def _or(v, default):
    return default if v is None or v == () else v


@register("Convolution", aliases=("conv",))
def _convolution_op(data, weight, bias=None, kernel=(), stride=(),
                    dilate=(), pad=(), num_filter=None, num_group=1,
                    no_bias=False, layout=None, cudnn_off=False,
                    cudnn_tune=None, workspace=1024, **_):
    """The registered ``Convolution``: :func:`convolution` with the JAX
    op's attributes (an empty ``stride``/``dilate``/``pad`` is the
    default; ``cudnn_*`` and ``workspace`` are accepted and ignored).
    ``layout`` None, ``"NCW"``, ``"NCHW"`` or ``"NCDHW"`` (the JAX op's
    default) takes channel-first data and OI+spatial weights through the
    channel-last path."""
    del cudnn_off, cudnn_tune, workspace
    return nchw_call(convolution, data, weight, layout=layout, bias=bias,
                     kernel=_or(kernel, None), stride=_or(stride, 1),
                     dilate=_or(dilate, 1), pad=_or(pad, 0),
                     num_filter=num_filter, num_group=num_group,
                     no_bias=no_bias)


def convolution(data, weight, bias=None, kernel=None, stride=1, dilate=1,
                pad=0, num_filter=None, num_group=1, no_bias=False,
                layout="NHWC"):
    """1-, 2- or 3-D convolution (reference: src/operator/nn/
    convolution.cc) of channel-last ``data`` (N, *spatial, I) with
    ``weight`` (O, *kernel, I/G) in ``num_group`` groups G, dilated by
    ``dilate``, plus ``bias`` (O,) unless ``no_bias``; ``layout`` names
    the channel-last layout of the data's dimensions (``"NWC"``,
    ``"NHWC"``, ``"NDHWC"``).  A 2-D convolution takes its weight-gradient
    from K1 (grouped and depthwise too), a 1-D one through the 2-D path
    with a unit height; a 3-D one is cuDNN's forward and data-gradient
    and ``aten.convolution_backward``'s weight-gradient (the JAX package
    leaves it to XLA).  Mixed data and weight types raise, as in the JAX
    op."""
    op = "Convolution"
    nd = _spatial(data, op)
    _check_channel_last(layout, nd, op)
    groups = int(num_group)
    if weight.dim() != data.dim() or groups < 1 \
            or data.shape[-1] % groups or weight.shape[0] % groups \
            or weight.shape[-1] * groups != data.shape[-1]:
        raise MXNetError("%s: data %s and weight %s are not %s and O%sI of "
                         "one input width in %d groups"
                         % (op, tuple(data.shape), tuple(weight.shape),
                            layout, layout[1:-1], groups))
    k = tuple(weight.shape[1:-1])
    if kernel is not None and _tup(kernel, nd, "kernel") != k:
        raise MXNetError("%s: kernel %s disagrees with weight %s"
                         % (op, kernel, tuple(weight.shape)))
    if num_filter is not None and int(num_filter) != weight.shape[0]:
        raise MXNetError("%s: num_filter %s disagrees with weight %s"
                         % (op, num_filter, tuple(weight.shape)))
    stride, pad, dilate = (_tup(v, nd, name) for v, name in (
        (stride, "stride"), (pad, "pad"), (dilate, "dilate")))
    if nd == 3:
        out = _last(F.conv3d(_first(data), _first(weight), None, stride, pad,
                             dilate, groups))
    elif nd == 2:
        out = _Convolution.apply(data.contiguous(), weight.contiguous(),
                                 stride, pad, dilate, groups)
    else:
        out = _Convolution.apply(
            data.contiguous().unsqueeze(1), weight.contiguous().unsqueeze(1),
            (1,) + stride, (0,) + pad, (1,) + dilate, groups).squeeze(1)
    if bias is not None and not no_bias:
        out = out + bias
    return out


@register("Deconvolution")
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=None,
                  num_group=1, no_bias=True, layout=None, **_):
    """Transposed convolution (reference: src/operator/nn/
    deconvolution.cc; ``mxnet_tpu/ops/nn.py:191-233``) of channel-first
    ``data`` (N, I, *spatial) with ``weight`` (I, O/G, *kernel) in
    ``num_group`` groups G, output padded by ``adj`` on the high side.
    ``target_shape`` is accepted and unused, as in the JAX op; a supplied
    ``bias`` is added whatever ``no_bias`` says, as there.  Channel-last
    layouts raise, as in the JAX Gluon layers.  The 1-D and 2-D forms take
    their weight-gradient from K1 with the roles swapped
    (:class:`_Deconvolution`), the 3-D form aten's."""
    del target_shape, no_bias
    op = "Deconvolution"
    nd = _spatial(data, op)
    if not _channel_first(layout):
        raise MXNetError("%s: the port takes channel-first data only (layout "
                         "None or %r), as the JAX package; got %r"
                         % (op, CHANNEL_FIRST[nd], layout))
    groups = int(num_group)
    if weight.dim() != data.dim() or groups < 1 \
            or weight.shape[0] != data.shape[1] or data.shape[1] % groups:
        raise MXNetError("%s: data %s and weight %s are not %s and (in, "
                         "out/groups, *kernel) of %d groups"
                         % (op, tuple(data.shape), tuple(weight.shape),
                            CHANNEL_FIRST[nd], groups))
    k = tuple(weight.shape[2:])
    if kernel not in (None, ()) and _tup(kernel, nd, "kernel") != k:
        raise MXNetError("%s: kernel %s disagrees with weight %s"
                         % (op, kernel, tuple(weight.shape)))
    if num_filter is not None and int(num_filter) != weight.shape[1] * groups:
        raise MXNetError("%s: num_filter %s disagrees with weight %s in %d "
                         "groups" % (op, num_filter, tuple(weight.shape),
                                     groups))
    stride, dilate, pad, adj = (_tup(_or(v, d), nd, name) for v, d, name in (
        (stride, 1, "stride"), (dilate, 1, "dilate"), (pad, 0, "pad"),
        (adj, 0, "adj")))
    if nd == 3:
        out = F.conv_transpose3d(data, weight, None, stride, pad, adj, groups,
                                 dilate)
    elif nd == 2:
        out = _nchw(_Deconvolution.apply(_nhwc(data).contiguous(), weight,
                                         stride, pad, dilate, adj, groups))
    else:
        out = _nchw(_Deconvolution.apply(
            _nhwc(data.unsqueeze(2)).contiguous(), weight.unsqueeze(2),
            (1,) + stride, (0,) + pad, (1,) + dilate, (0,) + adj,
            groups)).squeeze(2)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


@register("FullyConnected", aliases=("fc",))
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **_):
    """``data @ weight.T + bias`` (reference: fully_connected.cc:239);
    ``flatten`` folds every axis after the first into one; ``no_bias``
    drops the bias (``num_hidden`` is read from the weight).  Operands of
    two types are promoted first, as ``jnp.matmul`` does (float16 data
    over float32 weights gives float32)."""
    del num_hidden
    x = data.reshape(data.shape[0], -1) if flatten else data
    x, weight = promote(x, weight)
    return F.linear(x, weight, None if no_bias else bias)


_ACTIVATIONS = {"relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
                "softrelu": F.softplus, "softsign": F.softsign}


@register("Activation")
def activation(data, act_type="relu", **_):
    """Element-wise activation (reference: src/operator/nn/activation.cc):
    relu, sigmoid, tanh, softrelu (softplus) or softsign."""
    f = _ACTIVATIONS.get(act_type)
    if f is None:
        raise ValueError("act_type %r is not one of %s"
                         % (act_type, ", ".join(_ACTIVATIONS)))
    return f(data)


@register("LeakyReLU")
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **_):
    """The LeakyReLU family (reference: src/operator/leaky_relu.cc): leaky,
    prelu (learned ``gamma`` along axis 1), elu, selu, gelu (exact,
    through erf, as ``jax.nn.gelu(approximate=False)``) and rrelu at its
    inference slope (the mean of the bounds)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if data.dim() > 1 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * (torch.exp(data) - 1.0))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data > 0, data,
                                   alpha * (torch.exp(data) - 1.0))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        return torch.where(data > 0, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise ValueError("unknown act_type %r" % (act_type,))


@register("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
               **_):
    """Layer normalization over ``axis`` with the biased variance and
    ``eps`` inside the root (reference: src/operator/nn/layer_norm.cc);
    ``output_mean_var`` is accepted and, as in the JAX package, ignored."""
    del output_mean_var
    mean = data.mean(dim=axis, keepdim=True)
    var = (data - mean).square().mean(dim=axis, keepdim=True)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


def _bn_nout(attrs):
    return 3 if attrs.get("output_mean_var") else 1


@register("BatchNorm", num_outputs=_bn_nout)
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   axis_name=None, **_):
    """The registered ``BatchNorm``: ``out``, or ``(out, mean, var)`` with
    ``output_mean_var``; the running statistics are the caller's to
    update (``momentum`` is read by the layer, not here)."""
    del momentum, cudnn_off
    if axis_name is not None:
        raise MXNetError("BatchNorm: axis_name (cross-device statistics) "
                         "is not ported")
    out = batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                     fix_gamma=fix_gamma, use_global_stats=use_global_stats,
                     axis=axis)
    return out if output_mean_var else out[0]


class _MaxPool(torch.autograd.Function):
    """NHWC 2-D max pool.  Forward: cuDNN's max pool (the JAX package's is
    XLA's ``reduce_window``); a padding it cannot express goes through an
    explicit ``-inf`` pad.  Backward: :func:`~.pool_bwd.maxpool_bwd`."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pad_lo, pad_hi):
        xv = _nchw(x)
        if pad_lo == pad_hi and all(2 * p <= k for p, k in zip(pad_lo,
                                                                kernel)):
            out = F.max_pool2d(xv, kernel, stride, pad_lo)
        else:
            xv = F.pad(xv, (pad_lo[1], pad_hi[1], pad_lo[0], pad_hi[0]),
                       value=float("-inf"))
            out = F.max_pool2d(xv, kernel, stride, 0)
        ctx.save_for_backward(x)
        ctx.kernel, ctx.stride, ctx.pad = kernel, stride, pad_lo
        return _nhwc(out)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dx = maxpool_bwd(x, dy.contiguous(), ctx.kernel, ctx.stride, ctx.pad)
        return dx, None, None, None, None


@register("Pooling")
def _pooling_op(data, kernel=(), pool_type="max", stride=(), pad=(),
                global_pool=False, pooling_convention="valid",
                count_include_pad=True, cudnn_off=False, p_value=2,
                layout=None, **_):
    """The registered ``Pooling``: :func:`pooling` with the JAX op's
    attributes (empty ``stride``/``pad`` are the defaults).  ``layout``
    None, ``"NCW"``, ``"NCHW"`` or ``"NCDHW"`` (the JAX op's default)
    takes channel-first data through the channel-last path."""
    del cudnn_off
    return nchw_call(pooling, data, layout=layout,
                     kernel=_or(kernel, 1), pool_type=pool_type,
                     stride=_or(stride, None), pad=_or(pad, 0),
                     global_pool=global_pool,
                     pooling_convention=pooling_convention,
                     count_include_pad=count_include_pad, p_value=p_value)


def pooling(data, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, p_value=2, layout="NHWC"):
    """1-, 2- or 3-D pooling of channel-last data (``layout`` ``"NWC"``,
    ``"NHWC"`` or ``"NDHWC"``; reference: src/operator/nn/pooling.cc):
    max, avg, sum or lp over ``kernel`` windows, ``valid`` (floor) or
    ``full`` (ceil) output sizes, ``global_pool`` over the whole plane.

    As the JAX package (``ops/nn.py:580``): the ``full`` convention pads
    the high side as far as the last window needs; max pads with
    ``-inf``; avg divides by the kernel's volume when ``count_include_pad``
    and ``valid``, and otherwise by the count of real elements, at least
    1 (a window wholly in the padding gives 0, never NaN); lp is
    ``(sum |x|^p)^(1/p)`` with ``p = p_value``, the padding adding 0.
    1-D pooling runs the 2-D path with a unit height (K2 for the max
    backward); 3-D pooling is aten's, with its backward."""
    nd = _spatial(data, "Pooling")
    _check_channel_last(layout, nd, "Pooling")
    if global_pool:
        kernel, stride, pad = tuple(data.shape[1:1 + nd]), 1, 0
    kernel = _tup(kernel, nd, "kernel")
    stride = _tup(stride, nd, "stride") if stride else (1,) * nd
    pad = _tup(pad, nd, "pad") if pad else (0,) * nd
    if nd == 1:
        return pooling(data.unsqueeze(1), (1,) + kernel, pool_type,
                       (1,) + stride, (0,) + pad, False, pooling_convention,
                       count_include_pad, p_value, "NHWC").squeeze(1)
    hi = []
    for i in range(nd):
        lo = pad[i]
        if pooling_convention == "full":
            size = data.shape[1 + i]
            out_sz = -(-(size + 2 * lo - kernel[i]) // stride[i]) + 1
            needed = (out_sz - 1) * stride[i] + kernel[i] - size - lo
            hi.append(max(needed, lo))
        else:
            hi.append(lo)
    hi = tuple(hi)
    # F.pad's order: the last spatial axis first, low then high
    pads = tuple(v for i in reversed(range(nd)) for v in (pad[i], hi[i]))
    if pool_type == "max":
        if nd == 2:
            return _MaxPool.apply(data.contiguous(), kernel, stride, pad, hi)
        xv = F.pad(_first(data), pads, value=float("-inf"))
        return _last(F.max_pool3d(xv, kernel, stride, 0))
    if pool_type not in ("avg", "sum", "lp"):
        raise ValueError("unknown pool_type %r" % (pool_type,))
    avg_pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    p = float(p_value)
    x = torch.pow(torch.abs(data), p) if pool_type == "lp" else data
    xv = F.pad(_first(x), pads)
    summed = _last(avg_pool(xv, kernel, stride, 0, divisor_override=1))
    if pool_type == "sum":
        return summed
    if pool_type == "lp":
        return torch.pow(summed, 1.0 / p)
    if count_include_pad and pooling_convention != "full":
        return summed / float(np.prod(kernel))
    ones = torch.ones((1, 1) + tuple(data.shape[1:1 + nd]), dtype=data.dtype,
                      device=data.device)
    counts = avg_pool(F.pad(ones, pads), kernel, stride, 0,
                      divisor_override=1)
    return summed / _last(counts).clamp_min(1.0)


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance", **_):
    """Each entry over the L2 norm of its instance (every axis but the
    first), channel (axis 1) or spatial position (every axis after the
    second), ``sqrt(sum x^2 + eps)`` (reference:
    src/operator/l2_normalization.cc; ``mxnet_tpu/ops/nn.py:550``)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, data.dim()))
    else:
        raise MXNetError("L2Normalization: mode must be instance, channel "
                         "or spatial, not %r" % (mode,))
    norm = torch.sqrt(data.square().sum(dim=red, keepdim=True) + eps)
    return data / norm


def dropout(data, p=0.5, training=False, axes=()):
    """Dropout (reference: src/operator/nn/dropout.cc); the identity
    unless ``training`` (inference never drops).

    In training, a Bernoulli keep mask of rate ``1 - p``, scaled by
    ``1 / (1 - p)``, drawn from the port's generator of ``data``'s device
    (:func:`~mxnet_tpu_torch.random.generator`); the mask is shared along
    ``axes``."""
    if not training or p <= 0:
        return data
    keep = 1.0 - p
    shape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    prob = torch.full(shape, keep, dtype=torch.float32, device=data.device)
    mask = torch.bernoulli(prob, generator=_random.generator(data.device))
    return data * (mask.to(data.dtype) / keep)


@register("Dropout")
def _dropout_op(data, p=0.5, mode="training", axes=(), cudnn_off=False,
                **_):
    """The registered ``Dropout``: drops in train mode
    (:func:`~mxnet_tpu_torch.autograd.is_training`) or with
    ``mode="always"``."""
    del cudnn_off
    return dropout(data, p=p, axes=tuple(axes),
                   training=mode == "always" or _autograd.is_training())


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None, **_):
    """Softmax along ``axis`` (reference: src/operator/nn/softmax.cc),
    with ``temperature`` and, with ``length``, rows masked past their
    length (masked places are exactly 0); integer data gives float32."""
    ax = int(axis)
    x = data if data.is_floating_point() else data.float()
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is None:
        return torch.softmax(x, dim=ax)
    steps = torch.arange(x.shape[ax], device=x.device)
    shape = [1] * x.dim()
    shape[ax] = -1
    mask = steps.reshape(shape) < length.unsqueeze(ax)
    out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=ax)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None, **_):
    """``log(softmax(data))`` along ``axis``, computed stably (reference:
    src/operator/nn/softmax.cc), with ``temperature``; integer data gives
    float32."""
    if not data.is_floating_point():
        data = data.float()
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=int(axis))


# ------------------------------------------------------------ loss heads


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward is the fused cross-entropy gradient
    ``(softmax - onehot(label)) * scale`` and ignores the incoming
    cotangent (reference: src/operator/softmax_output.cc;
    ``mxnet_tpu/ops/nn.py:336-379``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, normalization, smooth_alpha):
        axis = 1 if multi_output else -1
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.cfg = (axis, grad_scale, ignore_label, use_ignore,
                   normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        del g  # SoftmaxOutput is the loss layer
        out, label = ctx.saved_tensors
        axis, grad_scale, ignore_label, use_ignore, normalization, \
            smooth_alpha = ctx.cfg
        ax = axis % out.dim()
        ncls = out.shape[ax]
        lab = label.to(torch.int32)
        shape = [1] * out.dim()
        shape[ax] = ncls
        classes = torch.arange(ncls, dtype=torch.int32, device=out.device)
        # one_hot's zeros for an out-of-range class, as jax.nn.one_hot
        onehot = (lab.unsqueeze(ax) == classes.reshape(shape)).to(out.dtype)
        if smooth_alpha:
            onehot = (onehot * (1.0 - smooth_alpha)
                      + smooth_alpha / (ncls - 1) * (1.0 - onehot))
        grad = out - onehot
        keep = None
        if use_ignore:
            keep = (lab != int(ignore_label)).to(out.dtype)
            grad = grad * keep.unsqueeze(ax)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid":
            if use_ignore:
                scale = scale / torch.clamp_min(keep.sum(), 1.0)
            else:
                scale = scale / float(lab.numel())
        grad = (grad * scale).to(out.dtype)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad, dlabel, None, None, None, None, None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0,
                   **_):
    """Softmax over the last axis (axis 1 with ``multi_output``) whose
    backward is the cross-entropy gradient against ``label``: ``grad_scale``
    times ``softmax - onehot``, label-smoothed by ``smooth_alpha``, with
    rows of ``ignore_label`` zeroed under ``use_ignore``, divided by the
    batch (``normalization="batch"``) or by the count of labels, or of the
    labels kept (``"valid"``).  ``preserve_shape`` and ``out_grad`` are
    accepted, as in the JAX package, and change nothing."""
    del preserve_shape, out_grad
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError("SoftmaxOutput: normalization must be null, batch "
                         "or valid, not %r" % (normalization,))
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(multi_output),
                                bool(use_ignore), str(normalization),
                                float(smooth_alpha))


class _RegressionOutput(torch.autograd.Function):
    """Identity (``"linear"``, ``"mae"``) or sigmoid (``"logistic"``)
    forward; the backward is ``pred - label`` (``sign(pred - label)`` for
    ``"mae"``) times ``grad_scale`` over the second axis's width, and
    ignores the incoming cotangent (reference:
    src/operator/regression_output.cc; ``mxnet_tpu/ops/nn.py:403-447``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, kind)
        return out

    @staticmethod
    def backward(ctx, g):
        del g
        out, label = ctx.saved_tensors
        grad_scale, kind = ctx.cfg
        diff = out - label.reshape(out.shape)
        grad = torch.sign(diff) if kind == "mae" else diff
        num = out.shape[1] if out.dim() > 1 else 1
        grad = (grad * (grad_scale / num)).to(out.dtype)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad, dlabel, None, None


def regression_output(data, label, grad_scale=1.0, kind="linear"):
    """The regression heads' op: see :class:`_RegressionOutput`."""
    return _RegressionOutput.apply(data, label, float(grad_scale), kind)


@register("LinearRegressionOutput")
def _linear_regression_output(data, label, grad_scale=1.0, **_):
    """Identity forward, L2 backward ``pred - label``."""
    return regression_output(data, label, grad_scale, "linear")


@register("MAERegressionOutput")
def _mae_regression_output(data, label, grad_scale=1.0, **_):
    """Identity forward, L1 backward ``sign(pred - label)``."""
    return regression_output(data, label, grad_scale, "mae")


@register("LogisticRegressionOutput")
def _logistic_regression_output(data, label, grad_scale=1.0, **_):
    """Sigmoid forward, cross-entropy backward ``pred - label``."""
    return regression_output(data, label, grad_scale, "logistic")


@register("CTCLoss", aliases=("ctc_loss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first", **_):
    """Connectionist temporal classification loss of each sample
    (``mxnet_tpu/ops/nn.py:794-863``; reference:
    src/operator/contrib/ctc_loss.cc): the negative log-likelihood of
    ``label`` under the (seq, batch, alphabet) activations ``data``, by
    the forward recursion in log space over the label extended with
    blanks, one time step at a time, as the JAX op's ``lax.scan``.

    ``blank_label``: the blank is class 0 (``"first"``; labels are 1-based
    and padded with 0) or the last class (``"last"``; labels 0-based,
    padded with -1).  ``use_data_lengths``/``use_label_lengths`` take
    each sample's lengths from the inputs (given only the label lengths,
    they may come in the third input, as the reference contracts its
    input list); past its data length a sample's recursion stands still.
    Impossible paths sit at -1e30, as in the JAX op.  Differentiable by
    PyTorch's autograd; no kernel of its own (the JAX op is a scan)."""
    if use_label_lengths and not use_data_lengths and label_lengths is None:
        label_lengths, data_lengths = data_lengths, None
    seq_len, batch, alphabet = data.shape
    logp = torch.log_softmax(data, dim=-1)
    blank = 0 if blank_label == "first" else alphabet - 1
    lab = label.to(torch.int64)
    max_lab = lab.shape[1]
    if label_lengths is not None and use_label_lengths:
        lab_len = label_lengths.to(torch.int64)
    else:
        lab_len = ((lab > 0) if blank == 0 else (lab >= 0)).sum(dim=1)
    if data_lengths is not None and use_data_lengths:
        dat_len = data_lengths.to(torch.int64)
    else:
        dat_len = torch.full((batch,), seq_len, dtype=torch.int64,
                             device=data.device)
    # the extended label: blanks between and around the labels
    pos = torch.arange(2 * max_lab + 1, device=data.device)
    ext = torch.where(pos % 2 == 0, blank,
                      lab[:, torch.clamp(pos // 2, max=max_lab - 1)])
    # a negative label reads the class it names from the end, as the JAX
    # op's gather does
    idx = torch.where(ext < 0, ext + alphabet, ext)
    neg = torch.full((), -1e30, dtype=logp.dtype, device=data.device)
    same = ext == torch.cat([torch.full((batch, 2), -1, dtype=ext.dtype,
                                        device=ext.device), ext[:, :-2]], 1)
    allow2 = ~((ext == blank) | same)
    first = torch.where(lab_len > 0, logp[0].gather(1, idx[:, 1:2])[:, 0],
                        neg)
    alpha = torch.cat([logp[0, :, blank:blank + 1], first[:, None],
                       neg.expand(batch, 2 * max_lab - 1)], 1)
    pad1, pad2 = neg.expand(batch, 1), neg.expand(batch, 2)
    for t in range(1, seq_len):
        shift1 = torch.cat([pad1, alpha[:, :-1]], 1)
        shift2 = torch.cat([pad2, alpha[:, :-2]], 1)
        stay = torch.logaddexp(alpha, shift1)
        cand = torch.where(allow2, torch.logaddexp(stay, shift2), stay)
        new = cand + logp[t].gather(1, idx)
        alpha = torch.where((t < dat_len)[:, None], new, alpha)
    p1 = alpha.gather(1, (2 * lab_len)[:, None])[:, 0]
    p2 = torch.where(lab_len > 0, alpha.gather(
        1, torch.clamp(2 * lab_len - 1, min=0)[:, None])[:, 0], neg)
    return -torch.logaddexp(p1, p2)
