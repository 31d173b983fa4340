"""Activation functionals (``paddle_tpu/nn/functional/activation.py``
counterpart): the same formulas, elementwise over torch tensors.

`gelu`'s default is the erf form (Swin's `nn.GELU()`), ``approximate=
True`` the tanh form GPT uses.  The in-place forms (`relu_`, `elu_`,
`hardtanh_`, `leaky_relu_`, `softmax_`, `tanh_`, `thresholded_relu_`)
write the result into their argument and return it, as Paddle's do.
`gumbel_softmax` and `rrelu` draw from the generator of the tensor's
device (`core.rng`): other numbers than JAX's keys, the same
distributions (ROADMAP C2.11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import rng
from ...core.dtypes import torch_dtype

__all__ = [
    "relu", "relu_", "relu6", "leaky_relu", "prelu", "elu", "selu", "celu",
    "gelu", "silu", "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
    "hardshrink", "softshrink", "tanhshrink", "softsign", "softplus",
    "softmax", "log_softmax", "log_sigmoid", "sigmoid", "tanh", "glu",
    "gumbel_softmax", "maxout", "rrelu", "thresholded_relu", "swiglu",
    "elu_", "hardtanh_", "leaky_relu_", "softmax_", "tanh_",
    "thresholded_relu_",
]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0, 6)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """A per-channel slope (channel axis 1, or last for channel-last
    formats) when `weight` has more than one element."""
    if weight.numel() > 1:
        shape = [1] * x.dim()
        axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape[axis] = weight.shape[0]
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return torch.clamp(x, min=0) + torch.clamp(alpha * torch.expm1(
        x / alpha), max=0)


def gelu(x, approximate=False, name=None):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return x * torch.sigmoid(x)


def swish(x, name=None):
    return x * torch.sigmoid(x)


def mish(x, name=None):
    return x * torch.tanh(F.softplus(x))


def hardswish(x, name=None):
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0, 1)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softsign(x, name=None):
    return x / (1 + torch.abs(x))


def softplus(x, beta=1, threshold=20, name=None):
    """log1p(exp(beta x)) / beta, x itself where beta x > threshold (the
    untaken branch kept finite, as JAX :116-119)."""
    big = x * beta > threshold
    safe = torch.where(big, _zero(x), x)
    return torch.where(big, x, torch.log1p(torch.exp(beta * safe)) / beta)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def glu(x, axis=-1, name=None):
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def swiglu(x, y=None, name=None):
    """silu(x) * y, over the two halves of x's last axis when y is not
    given (LLaMA's fused gate_up projection)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return x * torch.sigmoid(x) * y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with standard Gumbel noise g; with
    `hard`, the one-hot of its argmax with the soft gradient (straight
    through)."""
    u = torch.rand(x.shape, generator=rng.generator(x.device),
                   device=x.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = (-torch.log(-torch.log(u.clamp(min=tiny)))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y
    return y


def maxout(x, groups, axis=1, name=None):
    """out[..., j, ...] = max_k x[..., j + (c // groups) k, ...]: the
    groups are the outer factor of the channel axis (JAX :200-206)."""
    axis = axis % x.dim()
    c = x.shape[axis]
    shape = tuple(x.shape[:axis]) + (groups, c // groups) \
        + tuple(x.shape[axis + 1:])
    return x.reshape(shape).amax(dim=axis)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Negative inputs scaled by a slope drawn U(lower, upper) per
    element in training; by (lower + upper) / 2 in inference."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    a = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
        lower, upper, generator=rng.generator(x.device))
    return torch.where(x >= 0, x, a * x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x,
                       torch.full((), value, dtype=x.dtype, device=x.device))


def relu_(x, name=None):
    return torch.relu_(x)


def elu_(x, alpha=1.0, name=None):
    return x.copy_(elu(x, alpha))


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return x.clamp_(min, max)


def leaky_relu_(x, negative_slope=0.01, name=None):
    return x.copy_(leaky_relu(x, negative_slope))


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def tanh_(x, name=None):
    return x.tanh_()


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return x.copy_(thresholded_relu(x, threshold, value))
