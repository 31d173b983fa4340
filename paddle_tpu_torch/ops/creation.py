"""Tensor creation ops (``paddle_tpu/ops/creation.py`` counterpart).

A creation op with no input tensor puts its result on the default
device, `resolve_device(None)`: the card unless ``set_device("cpu")``
said otherwise, or the op's ``place`` / ``device`` names another
(ROADMAP C2.35).  The random ones draw from the port's per-device
generators (`core.rng`, C2.11), so ``seed(n)`` makes a run repeat
itself; they match the JAX package's distributions, not its numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core import rng as _rng
from ..core.device import resolve_device
from ._common import I64, scalar, tensor

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "arange", "linspace",
    "logspace", "eye", "zeros_like", "ones_like", "full_like", "empty_like",
    "rand", "randn", "randint", "randperm", "uniform", "normal",
    "standard_normal", "bernoulli", "multinomial", "poisson", "assign",
    "clone", "tril_", "diag", "diagflat", "meshgrid", "tril", "triu",
    "create_parameter", "complex", "as_tensor",
]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(scalar(s)) for s in shape)


def _dt(dtype, default=None):
    dtype = _dtypes.convert_dtype(dtype)
    if dtype is None:
        dtype = default or _dtypes.get_default_dtype()
    return dtype


def _device(place=None, device=None):
    return resolve_device(device if device is not None else place)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor (a copy) on `place` (the default device when None)
    from a tensor, a numpy array, a list or a number.  With no `dtype`,
    a float64 array or Python float takes the default dtype and an int
    stays int64 (the JAX package gives int32 there, C2.40)."""
    dt = _dtypes.convert_dtype(dtype)
    dev = _device(place)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=dt or data.dtype,
                               copy=True)
    else:
        arr = np.asarray(data)
        if dt is None and arr.dtype == np.float64:
            dt = _dtypes.get_default_dtype()
        if arr.dtype.kind == "U":
            raise TypeError("to_tensor: strings are not tensors")
        out = torch.tensor(arr, dtype=dt, device=dev)
    if not stop_gradient:
        out.requires_grad_()
    return out


def as_tensor(data, dtype=None, place=None):
    if isinstance(data, torch.Tensor) and (
            dtype is None or _dtypes.convert_dtype(dtype) == data.dtype):
        return data
    return to_tensor(data, dtype, place)


def zeros(shape, dtype=None, name=None, *, place=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=_device(place))


def ones(shape, dtype=None, name=None, *, place=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_device(place))


def full(shape, fill_value, dtype=None, name=None, *, place=None):
    fill_value = scalar(fill_value)
    if dtype is None and isinstance(fill_value, bool):
        dtype = "bool"
    elif dtype is None and isinstance(fill_value, int):
        dtype = "int64"
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=_device(place))


def empty(shape, dtype=None, name=None, *, place=None):
    # zero-filled, as the JAX package makes it
    return zeros(shape, dtype, place=place)


def arange(start=0, end=None, step=1, dtype=None, name=None, *, place=None):
    start, end, step = scalar(start), scalar(end), scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = "int64" if all(
            isinstance(x, (int, np.integer)) for x in (start, end, step)
        ) else _dtypes.get_default_dtype()
    return torch.arange(start, end, step, dtype=_dt(dtype, I64),
                        device=_device(place))


def linspace(start, stop, num, dtype=None, name=None, *, place=None):
    dt = _dt(dtype)
    out = torch.linspace(float(scalar(start)), float(scalar(stop)),
                         int(scalar(num)), dtype=torch.float64,
                         device=_device(place))
    return out.to(dt)


def logspace(start, stop, num, base=10.0, dtype=None, name=None, *,
             place=None):
    exps = linspace(start, stop, num, "float64", place=place)
    return torch.pow(float(scalar(base)), exps).to(_dt(dtype))


def eye(num_rows, num_columns=None, dtype=None, name=None, *, place=None):
    cols = num_rows if num_columns is None else num_columns
    return torch.eye(int(num_rows), int(cols), dtype=_dt(dtype),
                     device=_device(place))


def _like(x, dtype):
    return _dtypes.convert_dtype(dtype) or x.dtype


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_like(x, dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=_like(x, dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, scalar(fill_value), dtype=_like(x, dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def complex(real, imag, name=None):
    return torch.complex(real, imag)


# --- random ----------------------------------------------------------------

def rand(shape, dtype=None, name=None, *, place=None):
    return uniform(shape, dtype, min=0.0, max=1.0, place=place)


def randn(shape, dtype=None, name=None, *, place=None):
    dev = _device(place)
    return torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                       generator=_rng.generator(dev))


standard_normal = randn


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *,
            place=None):
    """U[min, max) from the device's generator, or from a generator
    seeded with `seed` when it is not 0 (as the JAX package keys it)."""
    dev = _device(place)
    gen = _rng.generator(dev)
    if seed:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return out.uniform_(float(min), float(max), generator=gen)


def normal(mean=0.0, std=1.0, shape=None, name=None, *, place=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        m, s = tensor(mean, like), tensor(std, like)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, dtype=like.dtype, device=like.device,
                        generator=_rng.generator(like.device))
        return z * s + m
    dev = _device(place)
    shp = _shape(shape if shape is not None else [1])
    z = torch.randn(shp, dtype=_dt(None), device=dev,
                    generator=_rng.generator(dev))
    return z * std + mean


def randint(low=0, high=None, shape=(1,), dtype=None, name=None, *,
            place=None):
    if high is None:
        low, high = 0, low
    dev = _device(place)
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=_dt(dtype, I64), device=dev,
                         generator=_rng.generator(dev))


def randperm(n, dtype="int64", name=None, *, place=None):
    dev = _device(place)
    return torch.randperm(int(n), device=dev,
                          generator=_rng.generator(dev)).to(
        _dt(dtype, I64))


def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=_rng.generator(x.device)).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, int(num_samples), bool(replacement),
                             generator=_rng.generator(x.device)).to(I64)


def poisson(x, name=None):
    return torch.poisson(x, generator=_rng.generator(x.device)).to(x.dtype)


# --- misc ------------------------------------------------------------------

def assign(x, output=None):
    if not isinstance(x, torch.Tensor):
        x = to_tensor(np.asarray(x), place=output.device
                      if output is not None else None)
    out = x.clone()
    if output is not None:
        from ._common import write

        return write(output, out)
    return out


def clone(x, name=None):
    return assign(x)


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D `x` on the `offset` diagonal of a square matrix filled with
    `padding_value`; the `offset` diagonal of a 2-D `x`."""
    if x.dim() != 1:
        return torch.diagonal(x, offset).clone()
    if padding_value == 0:
        return torch.diag(x, offset)
    n = x.shape[0] + abs(offset)
    return torch.diagonal_scatter(
        torch.full((n, n), padding_value, dtype=x.dtype, device=x.device),
        x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def tril_(x, diagonal=0, name=None):
    from ._common import write

    return write(x, tril(x, diagonal))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*args, indexing="ij"))


def create_parameter(shape, dtype=None, name=None, attr=None,
                     is_bias=False, default_initializer=None, *,
                     place=None):
    """A `Parameter` of `shape`: `default_initializer`'s draw, zeros for
    a bias, else U(-sqrt(6 / fan_in), sqrt(6 / fan_in)) with fan_in the
    first dim (JAX :275-292), on the default device."""
    from ..nn.layer_base import Parameter

    dtype, shp, dev = _dt(dtype), _shape(shape), _device(place)
    if default_initializer is not None:
        data = default_initializer(list(shp), dtype, device=dev,
                                   generator=_rng.generator(dev))
    elif is_bias:
        data = torch.zeros(shp, dtype=dtype, device=dev)
    else:
        fan_in = shp[0] if shp else 1
        bound = float(np.sqrt(6.0 / max(1, fan_in)))
        data = torch.empty(shp, dtype=dtype, device=dev).uniform_(
            -bound, bound, generator=_rng.generator(dev))
    p = Parameter(data)
    p.name = name
    return p
