"""BatchNorm2D (``paddle_tpu/nn/layers_norm.py:99`` counterpart; the
forward of `_BatchNormBase` :59-86).

Names match the JAX package's ``functional_state()``: parameters
`weight` (ones) and `bias` (zeros) in the layer's dtype, persistent
buffers `_mean` (zeros) and `_variance` (ones), always f32 as the JAX
package keeps them, so `load_reference_state(model, params, buffers)`
carries trained statistics across.  In training mode the forward
normalises with the batch statistics and updates the running ones in
place with `momentum` (Paddle's convention: 0.9 keeps 90% of the old
value).
"""
from __future__ import annotations

import torch
from torch import nn

from .functional import batch_norm


class BatchNorm2D(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device,
                                             dtype=dtype))
        self.register_buffer("_mean", torch.zeros(
            num_features, device=device, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            num_features, device=device, dtype=torch.float32))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self.momentum, epsilon=self.epsilon)
