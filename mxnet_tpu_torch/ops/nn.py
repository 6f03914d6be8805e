"""Neural-network ops of the PyTorch port, as plain functions on tensors.

Counterparts of ``mxnet_tpu/ops/nn.py`` Convolution, FullyConnected,
Activation, LeakyReLU (gelu), BatchNorm, LayerNorm, Pooling, Dropout,
log_softmax and the Module API's loss heads (SoftmaxOutput and the
regression outputs).  The JAX package leaves most of these to XLA; here they stay
plain PyTorch (matrix products go to cuBLAS, the convolutions' forward and
data-gradient and the max-pool forward to cuDNN).  Two gradients are the
port's own kernels, as the JAX package routes them to Pallas: a
convolution's weight-gradient (:mod:`.conv_dw`, K1a/K1b) and a max pool's
input-gradient (:mod:`.pool_bwd`, K2).  BatchNorm, which XLA fuses inside
the JAX package's step, is the port's own forward and backward kernels
(:mod:`.batch_norm`, K6a/K6b).  On the card they always run; there is no
flag.

Convolution and pooling take channel-last (NHWC) data and OHWI weights.
They run cuDNN on the NHWC tensors viewed as NCHW with ``channels_last``
strides, so nothing is copied.  The registered ``Convolution`` and
``Pooling`` and the Gluon layers also take the JAX ops' default layout
(``layout=None`` or ``"NCHW"``: NCHW data, OIHW weights): they permute
into the NHWC path and back (:func:`nchw_call`), so the weight-gradient
still runs K1 and the max-pool backward K2.  An NCHW result is the NHWC
result's NCHW view, ``channels_last`` in memory, so the next layer's
permute is free and only a network's first input is copied.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd as _autograd
from .. import random as _random
from ..base import MXNetError
from .batch_norm import batch_norm
from .conv_dw import conv_dw
from .pool_bwd import maxpool_bwd
from .registry import register

__all__ = ["convolution", "fully_connected", "activation", "leaky_relu",
           "batch_norm", "layer_norm", "pooling", "dropout", "softmax",
           "log_softmax", "softmax_output", "regression_output",
           "l2_normalization", "nchw_call"]


def _pair(v, what):
    t = (int(v),) * 2 if isinstance(v, int) else tuple(int(a) for a in v)
    if len(t) != 2:
        raise MXNetError("%s must have 2 entries for a 2-D op, got %s"
                         % (what, v))
    return t


def _nchw(t):
    """The NCHW view (``channels_last`` strides) of an NHWC tensor."""
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    """The NHWC view of an NCHW tensor."""
    return t.permute(0, 2, 3, 1)


def _channel_first(layout):
    """True for the registered ops' channel-first layouts (None, the JAX
    ops' default, or ``"NCHW"``)."""
    return layout is None or layout == "NCHW"


def _check_nhwc(layout, op):
    if layout != "NHWC":
        raise MXNetError("%s: the port takes layout='NHWC' (channel-last "
                         "data, OHWI weights); got %r" % (op, layout))


def _check_2d_layout(layout, op):
    """A 2-D op's layout: ``"NHWC"`` or the channel-first default."""
    if layout != "NHWC" and not _channel_first(layout):
        raise MXNetError("%s: the port takes layout 'NCHW' (NCHW data, OIHW "
                         "weights) or 'NHWC' (NHWC data, OHWI weights); got "
                         "%r" % (op, layout))


def nchw_call(fn, data, *weights, layout, **kwargs):
    """``fn`` (an NHWC op) on ``data`` and ``weights`` in ``layout``: in
    the channel-first layouts each 4-D argument is seen as NHWC (OHWI)
    and the result as NCHW again, both views (:func:`_nhwc`,
    :func:`_nchw`)."""
    if not _channel_first(layout):
        return fn(data, *weights, layout=layout, **kwargs)
    if data.dim() != 4 or any(w.dim() != 4 for w in weights):
        raise MXNetError("the port takes 2-D NCHW data and OIHW weights, got "
                         "%s" % [tuple(t.shape) for t in (data,) + weights])
    return _nchw(fn(_nhwc(data), *(_nhwc(w) for w in weights),
                    layout="NHWC", **kwargs))


class _Convolution(torch.autograd.Function):
    """NHWC/OHWI 2-D convolution.  Forward and data-gradient are cuDNN's
    (``F.conv2d`` and ``aten.convolution_backward``) as the JAX package
    leaves them to XLA; the weight-gradient is :func:`~.conv_dw.conv_dw`,
    cast to the weight's dtype (``ops/nn.py:180-181`` of the JAX
    package), dilated or not."""

    @staticmethod
    def forward(ctx, x, weight, stride, pad, dilate):
        out = F.conv2d(_nchw(x), _nchw(weight), None, stride, pad, dilate)
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.pad, ctx.dilate = stride, pad, dilate
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
                ctx.pad, ctx.dilate, False, (0, 0), 1,
                (True, False, False))[0])
        if ctx.needs_input_grad[1]:
            dw = conv_dw(x.contiguous(), dy, weight.shape[1:3], ctx.stride,
                         ctx.pad, ctx.dilate).to(weight.dtype)
        return dx, dw, None, None, None


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
    ``layout`` None or ``"NCHW"`` (the JAX op's default) takes NCHW data
    and OIHW weights through the NHWC path."""
    del cudnn_off, cudnn_tune, workspace
    return nchw_call(convolution, data, weight, layout=layout, bias=bias,
                     kernel=_or(kernel, None), stride=_or(stride, (1, 1)),
                     dilate=_or(dilate, (1, 1)), pad=_or(pad, (0, 0)),
                     num_filter=num_filter, num_group=num_group,
                     no_bias=no_bias)


def convolution(data, weight, bias=None, kernel=None, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), num_filter=None, num_group=1,
                no_bias=False, layout="NHWC"):
    """2-D convolution (reference: src/operator/nn/convolution.cc) of NHWC
    ``data`` (N, H, W, I) with OHWI ``weight`` (O, KH, KW, I), dilated by
    ``dilate``, plus ``bias`` (O,) unless ``no_bias``.  Groups other than
    1, and other layouts, raise :class:`MXNetError`."""
    _check_nhwc(layout, "Convolution")
    if int(num_group) != 1:
        raise MXNetError("Convolution: the port takes num_group=1 (got %s)"
                         % (num_group,))
    if data.dim() != 4 or weight.dim() != 4 \
            or weight.shape[3] != data.shape[3]:
        raise MXNetError("Convolution: data %s and weight %s are not NHWC "
                         "and OHWI of one input width"
                         % (tuple(data.shape), tuple(weight.shape)))
    if kernel is not None and _pair(kernel, "kernel") != tuple(
            weight.shape[1:3]):
        raise MXNetError("Convolution: kernel %s disagrees with weight %s"
                         % (kernel, tuple(weight.shape)))
    if num_filter is not None and int(num_filter) != weight.shape[0]:
        raise MXNetError("Convolution: num_filter %s disagrees with weight "
                         "%s" % (num_filter, tuple(weight.shape)))
    out = _Convolution.apply(data.contiguous(), weight.contiguous(),
                             _pair(stride, "stride"), _pair(pad, "pad"),
                             _pair(dilate, "dilate"))
    if bias is not None and not no_bias:
        out = out + bias
    return out


@register("FullyConnected", aliases=("fc",))
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **_):
    """``data @ weight.T + bias`` (reference: fully_connected.cc:239);
    ``flatten`` folds every axis after the first into one; ``no_bias``
    drops the bias (``num_hidden`` is read from the weight)."""
    del num_hidden
    x = data.reshape(data.shape[0], -1) if flatten else data
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
    None or ``"NCHW"`` (the JAX op's default) takes NCHW data through the
    NHWC path."""
    del cudnn_off
    return nchw_call(pooling, data, layout=layout,
                     kernel=_or(kernel, (1, 1)), pool_type=pool_type,
                     stride=_or(stride, None), pad=_or(pad, (0, 0)),
                     global_pool=global_pool,
                     pooling_convention=pooling_convention,
                     count_include_pad=count_include_pad, p_value=p_value)


def pooling(data, kernel=(1, 1), pool_type="max", stride=None, pad=(0, 0),
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, p_value=2, layout="NHWC"):
    """2-D pooling of NHWC data (reference: src/operator/nn/pooling.cc):
    max, avg, sum or lp over ``kernel`` windows, ``valid`` (floor) or
    ``full`` (ceil) output sizes, ``global_pool`` over the whole plane.

    As the JAX package (``ops/nn.py:580``): the ``full`` convention pads
    the high side as far as the last window needs; max pads with
    ``-inf``; avg divides by the kernel's area when ``count_include_pad``
    and ``valid``, and otherwise by the count of real elements, at least
    1 (a window wholly in the padding gives 0, never NaN); lp is
    ``(sum |x|^p)^(1/p)`` with ``p = p_value``, the padding adding 0."""
    _check_nhwc(layout, "Pooling")
    if data.dim() != 4:
        raise MXNetError("Pooling: the port takes 2-D NHWC data, got %s"
                         % (tuple(data.shape),))
    if global_pool:
        kernel, stride, pad = tuple(data.shape[1:3]), (1, 1), (0, 0)
    kernel = _pair(kernel, "kernel")
    stride = _pair(stride, "stride") if stride else (1, 1)
    pad = _pair(pad, "pad") if pad else (0, 0)
    hi = []
    for i in range(2):
        lo = pad[i]
        if pooling_convention == "full":
            size = data.shape[1 + i]
            out_sz = -(-(size + 2 * lo - kernel[i]) // stride[i]) + 1
            needed = (out_sz - 1) * stride[i] + kernel[i] - size - lo
            hi.append(max(needed, lo))
        else:
            hi.append(lo)
    hi = tuple(hi)
    if pool_type == "max":
        return _MaxPool.apply(data.contiguous(), kernel, stride, pad, hi)
    if pool_type not in ("avg", "sum", "lp"):
        raise ValueError("unknown pool_type %r" % (pool_type,))
    p = float(p_value)
    x = torch.pow(torch.abs(data), p) if pool_type == "lp" else data
    xv = F.pad(_nchw(x), (pad[1], hi[1], pad[0], hi[0]))
    summed = _nhwc(F.avg_pool2d(xv, kernel, stride, 0, divisor_override=1))
    if pool_type == "sum":
        return summed
    if pool_type == "lp":
        return torch.pow(summed, 1.0 / p)
    if count_include_pad and pooling_convention != "full":
        return summed / float(kernel[0] * kernel[1])
    ones = torch.ones((1, 1) + tuple(data.shape[1:3]), dtype=data.dtype,
                      device=data.device)
    counts = F.avg_pool2d(F.pad(ones, (pad[1], hi[1], pad[0], hi[0])),
                          kernel, stride, 0, divisor_override=1)
    return summed / _nhwc(counts).clamp_min(1.0)


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
