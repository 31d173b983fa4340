"""max_pool2d and adaptive_avg_pool2d (``paddle_tpu/nn/functional/
pooling.py:130`` and ``:187`` counterparts), NCHW."""
from __future__ import annotations

import torch.nn.functional as F


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Padded with -inf, floor mode (the JAX `_pool` ignores ceil_mode);
    `stride=None` is the kernel size."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def adaptive_avg_pool2d(x, output_size):
    """Mean over the buckets [floor(i*n/o), ceil((i+1)*n/o)) of each
    spatial axis, as the JAX `_adaptive` takes them."""
    return F.adaptive_avg_pool2d(x, output_size)
