"""layer_norm and rms_norm (``paddle_tpu/nn/functional/norm.py:19`` and
``:37`` counterparts)."""
from __future__ import annotations

import torch


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
    cast back to x's dtype, THEN weight and bias in that dtype."""
    x32 = _stats_dtype(x)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _affine(out, weight, bias)


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1):
    """x / sqrt(mean(x^2) + eps) over the axes from `begin_norm_axis`
    on.  As in the JAX package: the mean square in f32 for half-precision
    inputs, the normalised value cast back to x's dtype (in bf16 that
    rounding is part of the result), THEN weight and bias."""
    axis = begin_norm_axis if begin_norm_axis >= 0 \
        else x.dim() + begin_norm_axis
    x32 = _stats_dtype(x)
    ms = x32.square().mean(dim=tuple(range(axis, x.dim())), keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return _affine(out, weight, bias)
