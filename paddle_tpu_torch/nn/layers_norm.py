"""Normalization layers (``paddle_tpu/nn/layers_norm.py`` counterpart):
the batch norms (`_BatchNormBase` :59-86), SyncBatchNorm, GroupNorm, the
instance norms, LocalResponseNorm and SpectralNorm; `LayerNorm` and
`RMSNorm` live in `layers_common`.

Names match the JAX package's ``functional_state()``: parameters
`weight` (ones) and `bias` (zeros) in the layer's dtype, persistent
buffers `_mean` (zeros) and `_variance` (ones), always f32 as the JAX
package keeps them, so `load_reference_state(model, params, buffers)`
carries trained statistics across.  In training mode the forward
normalises with the batch statistics and updates the running ones in
place with `momentum` (Paddle's convention: 0.9 keeps 90% of the old
value); ``use_global_stats=True`` normalises with the running ones.
`SyncBatchNorm` in one process is `BatchNorm`, as in JAX.
"""
from __future__ import annotations

import math

import torch

from ..core.device import resolve_device
from . import functional as F
from .initializer import Constant
from .layer_base import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(
            num_features, device=dev, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            num_features, device=dev, dtype=torch.float32))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCDHW"
                         else "NHWC", use_global_stats, **kw)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm; one process computes its local batch
    statistics, as the JAX layer does eagerly."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon, data_format=layer.data_format,
                                device=layer._mean.device)
            new.weight = layer.weight
            new.bias = layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class _InstanceNormBase(Layer):
    """Unit weight and zero bias unless ``weight_attr=False``, which
    leaves out both (JAX :175-186)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self.epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter(
                [num_features], attr=None if bias_attr is False
                else bias_attr, is_bias=True)
        else:
            self.weight = None
            self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """`weight` divided by its largest singular value, estimated by
    `power_iters` power iterations from the parameters `weight_u` [h]
    and `weight_v` [w] (drawn by Paddle's default initializer), as JAX
    computes it: the iteration's u and v are not written back."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, device=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.axis = axis
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = weight_shape[axis]
        w = math.prod(weight_shape) // h
        self.weight_u = self.create_parameter([h])
        self.weight_v = self.create_parameter([w])

    def forward(self, weight):
        axis, eps = self.axis, self.epsilon
        perm = [axis] + [i for i in range(weight.dim()) if i != axis]
        mat = weight.permute(perm).reshape(weight.shape[axis], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v_ = mat.T @ u
            v_ = v_ / (torch.linalg.vector_norm(v_) + eps)
            u_ = mat @ v_
            u = u_ / (torch.linalg.vector_norm(u_) + eps)
            v = v_
        sigma = u @ mat @ v
        return weight / sigma
