"""Elementwise and scalar math ops (``paddle_tpu/ops/math.py``
counterpart), over torch tensors.  Each computes what the JAX op's
`jnp` body computes; where torch's op of the same name differs
(`lerp`'s formula, `imag` of a real tensor, `cummax`'s tie index, ...)
the JAX formula is written out."""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ..core import dtypes as _dtypes
from ._common import axes, gated, pair, tensor, write

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "float_power", "maximum", "minimum", "fmax", "fmin",
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "abs", "sign", "floor", "ceil", "round", "trunc", "frac",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "erf", "erfinv", "sigmoid", "logit", "square", "reciprocal",
    "clip", "neg", "lerp", "angle", "conj", "real", "imag",
    "scale", "stanh", "softplus_op", "rad2deg", "deg2rad",
    "isnan", "isinf", "isfinite", "nan_to_num", "heaviside",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "logaddexp", "logsumexp", "diff", "gcd", "lcm", "hypot", "copysign",
    "multiply_", "add_", "subtract_", "scale_", "clip_", "ldexp",
    "inner", "outer", "trapezoid", "increment", "nextafter",
    "digamma", "lgamma", "polygamma", "i0", "sgn",
]


def _bin(name, f):
    @gated(name)
    def g(x, y, name=None):
        return f(*pair(x, y))

    g.__name__ = name
    return g


def _un(name, f):
    @gated(name)
    def g(x, name=None):
        return f(x)

    g.__name__ = name
    return g


def _ldexp(x, y):
    # JAX truncates a float exponent to int32 (jnp.ldexp refuses floats)
    if y.is_floating_point():
        y = torch.trunc(y).to(torch.int32)
    if not x.is_floating_point():
        x = x.to(_dtypes.get_default_dtype())
    return x * torch.pow(torch.tensor(2.0, dtype=x.dtype, device=x.device),
                         y.to(x.dtype))


def _heaviside(x, y):
    x, y = torch.broadcast_tensors(x, y.to(x.dtype))
    return torch.where(x == 0, y, (x > 0).to(x.dtype))


add = _bin("add", torch.add)
subtract = _bin("subtract", torch.subtract)
multiply = _bin("multiply", torch.multiply)
divide = _bin("divide", torch.true_divide)
floor_divide = _bin("floor_divide", torch.floor_divide)
mod = _bin("mod", torch.remainder)
remainder = mod
maximum = _bin("maximum", torch.maximum)
minimum = _bin("minimum", torch.minimum)
fmax = _bin("fmax", torch.fmax)
fmin = _bin("fmin", torch.fmin)
atan2 = _bin("atan2", torch.atan2)
logaddexp = _bin("logaddexp", torch.logaddexp)
hypot = _bin("hypot", torch.hypot)
copysign = _bin("copysign", torch.copysign)
nextafter = _bin("nextafter", torch.nextafter)
heaviside = _bin("heaviside", _heaviside)
gcd = _bin("gcd", torch.gcd)
lcm = _bin("lcm", torch.lcm)
ldexp = _bin("ldexp", _ldexp)

exp = _un("exp", torch.exp)
expm1 = _un("expm1", torch.expm1)
log = _un("log", torch.log)
log2 = _un("log2", torch.log2)
log10 = _un("log10", torch.log10)
log1p = _un("log1p", torch.log1p)
sqrt = _un("sqrt", torch.sqrt)
rsqrt = _un("rsqrt", torch.rsqrt)
abs = _un("abs", torch.abs)
sign = _un("sign", torch.sign)
sgn = sign
floor = _un("floor", torch.floor)
ceil = _un("ceil", torch.ceil)
round = _un("round", torch.round)
trunc = _un("trunc", torch.trunc)
frac = _un("frac", lambda v: v - torch.trunc(v))
sin = _un("sin", torch.sin)
cos = _un("cos", torch.cos)
tan = _un("tan", torch.tan)
asin = _un("asin", torch.asin)
acos = _un("acos", torch.acos)
atan = _un("atan", torch.atan)
sinh = _un("sinh", torch.sinh)
cosh = _un("cosh", torch.cosh)
tanh = _un("tanh", torch.tanh)
asinh = _un("asinh", torch.asinh)
acosh = _un("acosh", torch.acosh)
atanh = _un("atanh", torch.atanh)
erf = _un("erf", torch.erf)
erfinv = _un("erfinv", torch.erfinv)
sigmoid = _un("sigmoid", torch.sigmoid)
square = _un("square", torch.square)
reciprocal = _un("reciprocal", torch.reciprocal)
neg = _un("neg", torch.neg)
angle = _un("angle", torch.angle)
conj = _un("conj", lambda v: torch.conj_physical(v) if v.is_complex()
           else v)
real = _un("real", lambda v: torch.real(v) if v.is_complex() else v)
imag = _un("imag", lambda v: torch.imag(v) if v.is_complex()
           else torch.zeros_like(v))
rad2deg = _un("rad2deg", torch.rad2deg)
deg2rad = _un("deg2rad", torch.deg2rad)
isnan = _un("isnan", torch.isnan)
isinf = _un("isinf", torch.isinf)
isfinite = _un("isfinite", torch.isfinite)
digamma = _un("digamma", torch.digamma)
lgamma = _un("lgamma", torch.lgamma)
i0 = _un("i0", torch.i0)


@gated("pow")
def pow(x, y, name=None):
    return torch.pow(x, y)


float_power = _bin("float_power", torch.float_power)


@gated("logit")
def logit(x, eps=None, name=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@gated("clip")
def clip(x, min=None, max=None, name=None):
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


@gated("lerp")
def lerp(x, y, weight, name=None):
    return x + weight * (y - x)


@gated("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    if isinstance(scale, torch.Tensor):
        scale = scale.to(x.dtype)
    if bias_after_scale:
        return x * scale + tensor(bias, x, x.dtype)
    return (x + tensor(bias, x, x.dtype)) * scale


@gated("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


@gated("softplus")
def softplus_op(x, beta=1, threshold=20, name=None):
    return _F.softplus(x, beta, threshold)


@gated("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan, posinf, neginf)


@gated("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    dtype = _dtypes.convert_dtype(dtype)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dtype)
    return torch.cumsum(x, int(axis), dtype=dtype)


@gated("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    dtype = _dtypes.convert_dtype(dtype)
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=dtype)
    return torch.cumprod(x, int(dim), dtype=dtype)


def _cum_ext(x, axis, dtype, vals_fn):
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % max(x.dim(), 1)
    vals = vals_fn(x, axis).values
    shape = [-1 if i == axis else 1 for i in range(x.dim())]
    idx = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    idx = torch.broadcast_to(idx, x.shape)
    # the last index at which the running extreme was reached (JAX
    # :238-246)
    ind = torch.cummax(torch.where(x == vals, idx, torch.full_like(idx, -1)),
                       axis).values
    return vals, ind.to(_dtypes.convert_dtype(dtype))


@gated("cummax")
def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_ext(x, axis, dtype, torch.cummax)


@gated("cummin")
def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_ext(x, axis, dtype, torch.cummin)


@gated("logcumsumexp")
def logcumsumexp(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, int(axis))


@gated("logsumexp")
def logsumexp(x, axis=None, keepdim=False, name=None):
    dim = axes(axis)
    if dim is None:
        dim = tuple(range(x.dim()))
    return torch.logsumexp(x, dim, keepdim=keepdim)


@gated("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, int(axis), prepend, append)


@gated("inner")
def inner(x, y, name=None):
    return torch.inner(x, y)


@gated("outer")
def outer(x, y, name=None):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@gated("trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x, dim=int(axis))
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=int(axis))


@gated("polygamma")
def polygamma(x, n, name=None):
    return torch.polygamma(int(n), x)


def increment(x, value=1.0, name=None):
    return write(x, add(x, value))


# --- in-place forms (C2.45) -------------------------------------------------

def add_(x, y, name=None):
    return write(x, add(x, y))


def subtract_(x, y, name=None):
    return write(x, subtract(x, y))


def multiply_(x, y, name=None):
    return write(x, multiply(x, y))


def scale_(x, scale_v=1.0, bias=0.0, bias_after_scale=True, name=None):
    return write(x, scale(x, scale_v, bias, bias_after_scale))


def clip_(x, min=None, max=None, name=None):
    return write(x, clip(x, min, max))

