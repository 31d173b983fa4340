"""Convolution and pooling layers (``paddle_tpu/nn/layers_conv_pool.py``
counterpart): Conv1D / Conv2D / Conv3D, the three transposed
convolutions, the average / max / adaptive pools and the unpools.

A conv's weight is ``[Cout, Cin / groups, *k]`` (``[Cin, Cout / groups,
*k]`` transposed), Paddle's and PyTorch's layout, drawn Kaiming-uniform
from the caller's generator as Paddle does (bound sqrt(6 / fan_in),
fan_in = Cin / groups * prod(k)); ``bias_attr=False`` means no bias,
anything else a zero bias.  `stride`, `padding`, `dilation`, `groups`
and `data_format` stay as given: the fused `conv_bn_act` gate reads
them.  `padding_mode` is accepted and unused, as in JAX.
"""
from __future__ import annotations

import math

import torch

from . import functional as F
from .initializer import KaimingUniform
from .layer_base import Layer

__all__ = [
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "Conv1D", "Conv2D", "Conv3D",
    "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
    "AvgPool1D", "AvgPool2D", "AvgPool3D",
    "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
]


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, transpose,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", output_padding=0, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self.output_padding = output_padding
        self._n = n
        if transpose:
            shape = [in_channels, out_channels // groups, *self.kernel_size]
        else:
            shape = [out_channels, in_channels // groups, *self.kernel_size]
        fan_in = (in_channels // groups) * math.prod(self.kernel_size)
        self.weight = self.create_parameter(
            shape, attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, False,
                         stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype, generator=generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, False,
                         stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype, generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, False,
                         stride, padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype, generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class _ConvTransposeNd(_ConvNd):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, n,
                 stride=1, padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, n, True,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format, output_padding,
                         device=device, dtype=dtype, generator=generator)

    def forward(self, x, output_size=None):
        return type(self)._fn(x, self.weight, self.bias, self.stride,
                              self.padding, self.output_padding, self.groups,
                              self.dilation, output_size, self.data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, **kw)


class Conv2DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, **kw)


class Conv3DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, **kw)


class _PoolNd(Layer):
    def __init__(self, fn, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self.fn = fn
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kw

    def forward(self, x):
        return self.fn(x, self.kernel_size, self.stride, self.padding,
                       **self.kw)


class AvgPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(F.avg_pool1d, kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=data_format)


class AvgPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(F.avg_pool3d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=data_format)


class MaxPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(F.max_pool1d, kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode)


class MaxPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(F.max_pool2d, kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class MaxPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(F.max_pool3d, kernel_size, stride, padding,
                         return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class _AdaptivePoolNd(Layer):
    def __init__(self, fn, output_size, **kw):
        super().__init__()
        self.fn = fn
        self.output_size = output_size
        self.kw = kw

    def forward(self, x):
        return self.fn(x, self.output_size, **self.kw)


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    def __init__(self, output_size, name=None):
        super().__init__(F.adaptive_avg_pool1d, output_size)


class AdaptiveAvgPool2D(_AdaptivePoolNd):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size)


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(F.adaptive_avg_pool3d, output_size)


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool1d, output_size)


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool2d, output_size)


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool3d, output_size)


class _MaxUnPoolNd(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.kw = dict(kernel_size=kernel_size, stride=stride,
                       padding=padding, data_format=data_format,
                       output_size=output_size)

    def forward(self, x, indices):
        return type(self)._fn(x, indices, **self.kw)


class MaxUnPool1D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPoolNd):
    _fn = staticmethod(F.max_unpool3d)
