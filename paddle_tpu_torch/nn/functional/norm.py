"""Normalization functionals (``paddle_tpu/nn/functional/norm.py``
counterpart): layer_norm (:19), rms_norm (:37), batch_norm (:52-108),
instance_norm, group_norm and local_response_norm, in the JAX package's
rounding order."""
from __future__ import annotations

import torch

from ...amp import gate as _amp


def _stats_dtype(x):
    """Half-precision inputs take their statistics in f32."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _affine(out, weight, bias):
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalise over the trailing axes of `normalized_shape` (an int or
    a shape).  Same order as the JAX package: statistics in f32 for
    half-precision inputs, the normalised value cast back to x's dtype,
    THEN weight and bias in that dtype (f32 for all three under
    `amp.auto_cast`)."""
    x, weight, bias = _amp.cast("layer_norm", x, weight, bias)
    n_axes = 1 if isinstance(normalized_shape, int) \
        else len(tuple(normalized_shape))
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    x32 = _stats_dtype(x)
    mean = x32.mean(dim=axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _amp.seen("layer_norm", _affine(out, weight, bias))


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """x / sqrt(mean(x^2) + eps) over the axes from `begin_norm_axis`
    on.  As in the JAX package: the mean square in f32 for half-precision
    inputs, the normalised value cast back to x's dtype (in bf16 that
    rounding is part of the result), THEN weight and bias."""
    x, weight, bias = _amp.cast("rms_norm", x, weight, bias)
    axis = begin_norm_axis if begin_norm_axis >= 0 \
        else x.dim() + begin_norm_axis
    x32 = _stats_dtype(x)
    ms = x32.square().mean(dim=tuple(range(axis, x.dim())), keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return _amp.seen("rms_norm", _affine(out, weight, bias))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over channel axis 1 (NCHW; axis 1 of a 2-D input too;
    the last axis for a channel-last `data_format`; ``use_global_stats``
    normalises with the running statistics even in training),
    the JAX package's order: for half-precision inputs normalise in f32,
    cast the normalised value back to x's dtype, THEN weight and bias in
    that dtype (in training under `amp.auto_cast` x, weight and bias
    in f32, the JAX op "batch_norm").  Inference uses the running
    statistics.  In training the
    biased batch mean and variance (f32 for half-precision inputs)
    normalise, and the f32 running statistics are updated in place,
    outside autograd, by Paddle's convention: ``m * running + (1 - m) *
    batch`` with the unbiased variance ``var * n / (n - 1)``.  (The fused
    `conv_bn_act` folds the inference statistics in another order.)"""
    training = training and not use_global_stats
    if training:
        x, weight, bias = _amp.cast("batch_norm", x, weight, bias)
    c_axis = 1 if data_format.startswith("NC") or x.dim() == 2 \
        else x.dim() - 1
    shape = [1] * x.dim()
    shape[c_axis] = -1
    x32 = _stats_dtype(x)
    if training:
        # var = mean((x - mean)^2), as jnp.var: autograd then keeps one
        # f32 copy of the activation (the centred x), not two
        axes = tuple(i for i in range(x.dim()) if i != c_axis)
        mean = x32.mean(dim=axes)
        centred = x32 - mean.reshape(shape)
        var = centred.square().mean(dim=axes)
        n = x.numel() // x.shape[c_axis]
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean.float(),
                                             alpha=1 - momentum)
            running_var.mul_(momentum).add_(
                var.float() * (n / max(1, n - 1)), alpha=1 - momentum)
    else:
        centred, var = x32 - running_mean.reshape(shape), running_var
    out = (centred * torch.rsqrt(var.reshape(shape) + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return _amp.seen("batch_norm", out) if training else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over its spatial axes with its
    own statistics (channel axis 1); the running statistics are taken
    and unused, as in JAX."""
    (x, weight, bias) = _amp.cast("instance_norm", x, weight, bias)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.dim()
    shape[1] = -1
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Channels split into `num_groups` groups, each normalised over its
    channels and spatial axes; NHWC moves the channels to axis 1 and
    back."""
    (x, weight, bias) = _amp.cast("group_norm", x, weight, bias)
    xt = x.movedim(-1, 1) if data_format == "NHWC" else x
    n, c = xt.shape[0], xt.shape[1]
    g = xt.reshape((n, num_groups, c // num_groups) + tuple(xt.shape[2:]))
    axes = tuple(range(2, g.dim()))
    mean = g.mean(dim=axes, keepdim=True)
    var = (g - mean).square().mean(dim=axes, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(xt.shape)
    shape = [1] * xt.dim()
    shape[1] = -1
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.movedim(1, -1) if data_format == "NHWC" else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * sum of squares over `size` neighbouring
    channels) ** beta, the window zero-padded size // 2 before and the
    rest after (JAX :151-171: alpha multiplies the sum, not its mean)."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = x.square()
    half = size // 2
    pads = [0, 0] * x.dim()
    # F.pad lists the last axis first
    at = 2 * (x.dim() - 1 - c_axis)
    pads[at], pads[at + 1] = half, size - half - 1
    padded = torch.nn.functional.pad(sq, pads)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + padded.narrow(c_axis, i, x.shape[c_axis])
    return x / torch.pow(k + alpha * acc, beta)
