"""Reductions and search ops (``paddle_tpu/ops/reduction.py``
counterpart).  Index outputs are int64 (C2.40); `mode` and `kthvalue`
pick the indices the JAX bodies pick (:139-171)."""
from __future__ import annotations

import torch

from ..core import dtypes as _dtypes
from ._common import I64, axes, gated

__all__ = [
    "sum", "mean", "max", "min", "prod", "amax", "amin", "nansum", "nanmean",
    "std", "var", "median", "nanmedian", "quantile", "all", "any",
    "argmax", "argmin", "count_nonzero", "mode", "kthvalue",
]


def _dims(x, axis):
    dim = axes(axis)
    if dim is None:
        return tuple(range(x.dim()))
    return dim if isinstance(dim, tuple) else (dim,)


@gated("sum")
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    dtype = _dtypes.convert_dtype(dtype)
    if dtype is None and x.dtype == torch.bool:
        dtype = I64
    return torch.sum(x, _dims(x, axis), keepdim=keepdim, dtype=dtype)


@gated("mean")
def mean(x, axis=None, keepdim=False, name=None):
    return torch.mean(x, _dims(x, axis), keepdim=keepdim)


def _ext(f, x, axis, keepdim):
    if x.dim() == 0:
        return x.clone()
    return f(x, _dims(x, axis), keepdim=keepdim)


@gated("max")
def max(x, axis=None, keepdim=False, name=None):
    return _ext(torch.amax, x, axis, keepdim)


@gated("min")
def min(x, axis=None, keepdim=False, name=None):
    return _ext(torch.amin, x, axis, keepdim)


amax = max
amin = min


def _flat_dim(x, axis, keepdim, f, **kw):
    """`f` over several axes: those axes moved last and flattened."""
    dims = _dims(x, axis)
    if len(dims) == 1:
        return f(x, dims[0], keepdim=keepdim, **kw)
    nd = x.dim()
    dims = sorted(d % nd for d in dims)
    rest = [d for d in range(nd) if d not in dims]
    moved = x.permute(rest + dims).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = f(moved, -1, keepdim=False, **kw)
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d)
    return out


@gated("prod")
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dtype = _dtypes.convert_dtype(dtype)
    if x.dim() == 0:
        return x.to(dtype) if dtype else x.clone()
    return _flat_dim(x, axis, keepdim, torch.prod, dtype=dtype)


@gated("nansum")
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(x, _dims(x, axis), keepdim=keepdim,
                        dtype=_dtypes.convert_dtype(dtype))


@gated("nanmean")
def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(x, _dims(x, axis), keepdim=keepdim)


@gated("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@gated("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(x, q, axis, keepdim, interpolation, nan):
    """`jnp.quantile` / `jnp.nanquantile` over several axes (torch's
    takes one)."""
    f = torch.nanquantile if nan else torch.quantile
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = f(x.reshape(-1), qt, 0, keepdim=False,
                interpolation=interpolation)
        if keepdim:
            out = out.reshape(out.shape + (1,) * x.dim())
        return out
    dims = _dims(x, axis)
    nd = x.dim()
    dims = sorted(d % nd for d in dims)
    rest = [d for d in range(nd) if d not in dims]
    moved = x.permute(rest + dims).reshape([x.shape[d] for d in rest] + [-1])
    out = f(moved, qt, -1, keepdim=False, interpolation=interpolation)
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d + (1 if qt.dim() else 0))
    return out


@gated("median")
def median(x, axis=None, keepdim=False, mode="avg", name=None):
    if mode == "avg":
        return _quantile(x, 0.5, axis, keepdim, "linear", False)
    # 'min' mode: the lower of the two middle elements
    ax = -1 if axis is None else int(axis)
    v = x.reshape(-1) if axis is None else x
    n = v.shape[ax]
    out = torch.sort(v, dim=ax).values.select(ax, (n - 1) // 2)
    if keepdim and axis is not None:
        out = out.unsqueeze(ax)
    return out


@gated("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, "linear", True)


@gated("quantile")
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(x, q, axis, keepdim, interpolation, False)


@gated("all")
def all(x, axis=None, keepdim=False, name=None):
    return _ext(torch.all, x.bool(), axis, keepdim) if x.dim() else x.bool()


@gated("any")
def any(x, axis=None, keepdim=False, name=None):
    return _ext(torch.any, x.bool(), axis, keepdim) if x.dim() else x.bool()


def _arg(f, x, axis, keepdim, dtype):
    if axis is None:
        out = f(x.reshape(-1))
    else:
        out = f(x, int(axis), keepdim=keepdim)
    return out.to(_dtypes.convert_dtype(dtype))


@gated("argmax")
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@gated("argmin")
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@gated("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return torch.sum(x != 0, _dims(x, axis), keepdim=keepdim, dtype=I64)


@gated("mode")
def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis`, the smallest of equally
    frequent ones, and the last index at which it occurs (JAX :139)."""
    moved = torch.movedim(x, axis, -1)
    srt = torch.sort(moved, dim=-1).values
    n = srt.shape[-1]
    new = torch.ones_like(srt, dtype=torch.bool)
    new[..., 1:] = srt[..., 1:] != srt[..., :-1]
    run_id = torch.cumsum(new.to(torch.int64), -1) - 1
    counts = torch.zeros(srt.shape, dtype=torch.int64, device=x.device)
    counts.scatter_add_(-1, run_id, torch.ones_like(run_id))
    best = torch.argmax(counts, -1, keepdim=True)
    first = torch.argmax((run_id == best).to(torch.int8), -1, keepdim=True)
    val = torch.gather(srt, -1, first)
    idx = torch.arange(n, device=x.device).expand_as(moved)
    orig = torch.amax(torch.where(moved == val, idx, torch.full_like(idx, -1)),
                      -1)
    vals, idxs = val.squeeze(-1), orig.to(I64)
    if keepdim:
        vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
    return vals, idxs


@gated("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    srt, arg = torch.sort(x, dim=axis, stable=True)
    vals = srt.select(axis, int(k) - 1)
    idxs = arg.select(axis, int(k) - 1).to(I64)
    if keepdim:
        vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
    return vals, idxs

