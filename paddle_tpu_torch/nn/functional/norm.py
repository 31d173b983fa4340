"""layer_norm, rms_norm and batch_norm (``paddle_tpu/nn/functional/
norm.py:19``, ``:37`` and ``:52-108`` counterparts)."""
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


def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """Normalise over the last axis.  Same order as the JAX package:
    statistics in f32 for half-precision inputs, the normalised value
    cast back to x's dtype, THEN weight and bias in that dtype (f32 for
    all three under `amp.auto_cast`)."""
    x, weight, bias = _amp.cast("layer_norm", x, weight, bias)
    x32 = _stats_dtype(x)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _amp.seen("layer_norm", _affine(out, weight, bias))


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1):
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
               training=False, momentum=0.9, epsilon=1e-5):
    """Batch norm over channel axis 1 (NCHW; axis 1 of a 2-D input too),
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
    if training:
        x, weight, bias = _amp.cast("batch_norm", x, weight, bias)
    shape = [1] * x.dim()
    shape[1] = -1
    x32 = _stats_dtype(x)
    if training:
        # var = mean((x - mean)^2), as jnp.var: autograd then keeps one
        # f32 copy of the activation (the centred x), not two
        axes = tuple(i for i in range(x.dim()) if i != 1)
        mean = x32.mean(dim=axes)
        centred = x32 - mean.reshape(shape)
        var = centred.square().mean(dim=axes)
        n = x.numel() // x.shape[1]
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
