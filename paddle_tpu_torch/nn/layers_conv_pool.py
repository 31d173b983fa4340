"""Conv2D, MaxPool2D and AdaptiveAvgPool2D (counterparts of
``paddle_tpu/nn/layers_conv_pool.py:69``, ``:186`` and ``:218``).

`Conv2D.weight` is ``[Cout, Cin/groups, kh, kw]`` (Paddle's and
PyTorch's OIHW), drawn Kaiming-uniform from the caller's generator as
Paddle does (bound sqrt(6 / fan_in)); ``bias_attr=False`` means no
bias, anything else a zero bias.  `stride`, `padding`, `dilation` and
`groups` stay as given: the fused `conv_bn_act` gate reads them.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .functional import adaptive_avg_pool2d, conv2d, max_pool2d


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None, *,
                 device, dtype=torch.float32, generator=None):
        super().__init__()
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = ks
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        fan_in = (in_channels // groups) * ks[0] * ks[1]
        bound = math.sqrt(6.0 / fan_in)
        w = torch.empty(out_channels, in_channels // groups, *ks,
                        device=device, dtype=dtype)
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_channels, device=device, dtype=dtype))

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size)
