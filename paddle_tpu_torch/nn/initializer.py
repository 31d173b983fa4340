"""Weight initializers (``paddle_tpu/nn/initializer.py`` counterpart).

Each initializer is called as ``init(shape, dtype, device=, generator=)``
and returns a tensor of that shape, dtype and device, drawn from
`generator` (a `torch.Generator` on that device, or torch's default one
when None).  The distributions and fans are the JAX package's; a seed
gives other numbers than JAX's keys, as for sampling (ROADMAP C2.11).
Each draw happens in the target dtype on the target device, so the
port's layers keep the weights their earlier constructors drew: Linear
``uniform_(-b, b)`` with b = sqrt(6 / (fan_in + fan_out)), Embedding
``normal_(0, 1)``, Conv ``uniform_(-b, b)`` with b = sqrt(6 / fan_in).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
]


def _fans(shape):
    """(fan_in, fan_out) as JAX's `_fans` (:21): [in, out] for 2-D
    (Paddle's Linear layout), [out, in, *k] beyond."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return gains.get(nonlinearity, 1.0)


def _empty(shape, dtype, device):
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device=device)


class Initializer:
    def __call__(self, shape, dtype, device=None, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device=None, generator=None):
        return _empty(shape, dtype, device).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None, generator=None):
        return _empty(shape, dtype, device).normal_(self.mean, self.std,
                                                    generator=generator)


class TruncatedNormal(Initializer):
    """N(mean, std) cut to [a, b] (absolute bounds, as JAX :82-85)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype, device=None, generator=None):
        t = _empty(shape, torch.float32, device)
        torch.nn.init.trunc_normal_(t, self.mean, self.std, self.a, self.b,
                                    generator=generator)
        return t.to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device=None, generator=None):
        return _empty(shape, dtype, device).uniform_(self.low, self.high,
                                                     generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None, generator=None):
        fi, fo = _fans(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _empty(shape, dtype, device).normal_(0.0, std,
                                                    generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None, generator=None):
        fi, fo = _fans(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        bound = self.gain * math.sqrt(6.0 / (fi + fo))
        return _empty(shape, dtype, device).uniform_(-bound, bound,
                                                     generator=generator)


def _kaiming_scale(fan_in, nonlinearity, negative_slope, k):
    """gain * sqrt(k / fan_in), written sqrt(2 k / ((1 + a^2) fan_in))
    for leaky_relu (the same number; with a = 0 exactly sqrt(2 k /
    fan_in), the bound the port's conv layers always drew)."""
    if nonlinearity == "leaky_relu":
        a = 0.01 if negative_slope is None else negative_slope
        return math.sqrt(2.0 * k / ((1 + a * a) * fan_in))
    return calculate_gain(nonlinearity, negative_slope) \
        * math.sqrt(k / fan_in)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None, generator=None):
        fi = self.fan_in or _fans(shape)[0]
        std = _kaiming_scale(fi, self.nonlinearity, self.negative_slope, 1.0)
        return _empty(shape, dtype, device).normal_(0.0, std,
                                                    generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None, generator=None):
        fi = self.fan_in or _fans(shape)[0]
        bound = _kaiming_scale(fi, self.nonlinearity, self.negative_slope,
                               3.0)
        return _empty(shape, dtype, device).uniform_(-bound, bound,
                                                     generator=generator)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype, device=None, generator=None):
        v = self.value if isinstance(self.value, torch.Tensor) \
            else torch.as_tensor(np.asarray(self.value))
        return v.detach().reshape(tuple(int(s) for s in shape)).to(
            device=device, dtype=dtype).clone()


class Orthogonal(Initializer):
    """Q of the QR of a [max(r, c), min(r, c)] normal draw, its columns'
    signs fixed by R's diagonal, transposed when r < c (JAX :167)."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype, device=None, generator=None):
        shape = tuple(int(s) for s in shape)
        rows, cols = shape[0], int(np.prod(shape[1:]))
        a = torch.empty(max(rows, cols), min(rows, cols),
                        dtype=torch.float32, device=device)
        a.normal_(0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype, device=None, generator=None):
        shape = tuple(int(s) for s in shape)
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                out[(g * (oc // self.groups) + i, i, *centers)] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


def _resolve_initializer(init, shape, is_bias):
    """JAX :197: None -> zeros for a bias, else U(-1/sqrt(fan_in),
    1/sqrt(fan_in)); an Initializer as it is; a callable ``f(shape,
    dtype)`` wrapped (its result moved to the device)."""
    if init is None:
        if is_bias:
            return Constant(0.0)
        fan_in, _ = _fans(shape)
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        return Uniform(-bound, bound)
    if isinstance(init, Initializer):
        return init
    if callable(init):
        class _Wrap(Initializer):
            def __call__(self, s, d, device=None, generator=None):
                r = init(s, d)
                return torch.as_tensor(np.asarray(r) if not isinstance(
                    r, torch.Tensor) else r).to(device=device, dtype=d)

        return _Wrap()
    raise TypeError(f"invalid initializer {init!r}")
