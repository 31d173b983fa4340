"""dropout, dropout2d, dropout3d and alpha_dropout
(``paddle_tpu/nn/functional/common.py:47-95`` counterparts).

Plain PyTorch on every device, as in the JAX package, which computes
dropout outside any Pallas kernel.  The keep mask is uniform < 1 - p
drawn from the generator of the tensor's device (`core.rng`), in the
mask's shape: x's, or 1 on every axis but those of `axis`.  The kept
values keep JAX's rounding, ``where(keep, x / (1 - p), 0)`` in x's dtype
(:64), with 1 - p rounded to x's dtype first as JAX rounds its
weak-typed scalar.  Autograd saves the mask, so the backward scales the
gradient by the forward's mask.
"""
from __future__ import annotations

import torch

from ...core import rng

_ALPHA = 1.6732632423543772
_SCALE = 1.0507009873554805


def _keep(x, p, shape):
    u = torch.rand(shape, generator=rng.generator(x.device),
                   device=x.device)
    return u < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element (or each slice along `axis`) with probability
    `p`.  ``upscale_in_train`` scales the kept values by 1 / (1 - p) in
    training and is the identity in inference; ``downscale_in_infer``
    keeps them as they are in training and scales by 1 - p in
    inference."""
    if not training or p == 0.0:
        if training or mode != "downscale_in_infer" or p == 0.0:
            return x
        return x * (1.0 - p)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep(x, p, shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        # JAX divides by 1 - p rounded to x's dtype (a weak-typed scalar)
        keep_rate = torch.tensor(1.0 - p, dtype=x.dtype).item()
        return torch.where(keep, x / keep_rate, zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels of [N, C, H, W] (or NHWC) dropped."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Whole channels of [N, C, D, H, W] (or NDHWC) dropped."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take the SELU's negative
    saturation, then an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    keep = _keep(x, p, x.shape)
    alpha_p = -_ALPHA * _SCALE
    a = 1.0 / (_SCALE * ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    out = a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                              device=x.device)) + b
    return out.to(x.dtype)
