"""ReLU, ReLU6 and GELU (``paddle_tpu/nn/layers_activation.py``
counterparts); GELU defaults to the erf form, as the JAX layer does."""
from __future__ import annotations

from torch import nn

from .functional import gelu, relu, relu6


class ReLU(nn.Module):
    def forward(self, x):
        return relu(x)


class ReLU6(nn.Module):
    def forward(self, x):
        return relu6(x)


class GELU(nn.Module):
    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return gelu(x, self.approximate)
