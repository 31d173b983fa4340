"""layer_norm (``paddle_tpu/nn/functional/norm.py:19`` counterpart)."""
from __future__ import annotations

import torch


def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """Normalise over the last axis.  Same order as the JAX package:
    statistics in f32 for half-precision inputs, the normalised value
    cast back to x's dtype, THEN weight and bias in that dtype."""
    x32 = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
