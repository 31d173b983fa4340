"""Shape, layout and indexing ops (``paddle_tpu/ops/manipulation.py``
counterpart).

Where the JAX body has semantics torch's op of the same name lacks,
they are written out: `scatter` drops an out-of-range index (JAX's
``mode="drop"``, :264) and keeps the last of duplicate rows, `topk` and
`argsort` order ties as `jax.lax.top_k` / a flipped stable `argsort` do
(:418-446), `strided_slice` takes negative strides, and `pad`'s
reflect / edge / wrap modes pad any axis as `jnp.pad` does.
"""
from __future__ import annotations

_pyslice = slice  # the op below shadows the builtin

import numpy as np
import torch
import torch.nn.functional as _F

from ..core import dtypes as _dtypes
from ._common import I64, gated, ints, scalar, tensor, write

__all__ = [
    "reshape", "reshape_", "transpose", "moveaxis", "swapaxes", "concat",
    "stack", "vstack", "hstack", "dstack", "split", "tensor_split", "chunk",
    "squeeze", "squeeze_", "unsqueeze", "unsqueeze_", "flatten", "unflatten",
    "expand", "expand_as", "broadcast_to", "broadcast_tensors", "tile",
    "flip", "rot90", "roll", "gather", "gather_nd", "scatter", "scatter_",
    "scatter_nd", "scatter_nd_add", "index_select", "index_sample",
    "index_add", "index_put", "masked_select", "masked_fill",
    "masked_scatter", "where", "nonzero", "take", "take_along_axis",
    "put_along_axis", "one_hot", "topk", "sort", "argsort", "searchsorted",
    "bucketize", "unique", "unique_consecutive", "unbind", "cast", "getitem",
    "slice", "strided_slice", "crop", "pad", "repeat_interleave",
    "shard_index", "flatten_", "as_complex", "as_real", "view", "view_as",
    "atleast_1d", "atleast_2d", "atleast_3d", "tensordot", "numel", "rank",
    "shape_op", "tolist", "diagonal", "kron", "renorm", "trace",
]


@gated("cast")
def cast(x, dtype):
    return x.to(_dtypes.convert_dtype(dtype))


@gated("reshape")
def reshape(x, shape, name=None):
    return torch.reshape(x, ints(shape))


def reshape_(x, shape, name=None):
    return write(x, reshape(x, shape))


view = reshape


def view_as(x, other, name=None):
    return reshape(x, list(other.shape))


@gated("transpose")
def transpose(x, perm=None, name=None):
    if perm is None:
        perm = list(range(x.dim()))[::-1]
    return x.permute(ints(perm))


@gated("moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


@gated("swapaxes")
def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(x, int(axis0), int(axis1))


@gated("concat")
def concat(x, axis=0, name=None):
    return torch.cat(list(x), int(scalar(axis)))


@gated("stack")
def stack(x, axis=0, name=None):
    return torch.stack(list(x), int(axis))


@gated("vstack")
def vstack(x, name=None):
    return torch.vstack(list(x))


@gated("hstack")
def hstack(x, name=None):
    return torch.hstack(list(x))


@gated("dstack")
def dstack(x, name=None):
    return torch.dstack(list(x))


def split(x, num_or_sections, axis=0, name=None):
    axis = int(scalar(axis))
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: axis {axis} length {dim} is not divisible by "
                f"{num_or_sections}; pass explicit section sizes or use "
                f"tensor_split for uneven splits")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = ints(num_or_sections)
        if any(s < 0 for s in sizes):
            rest = dim - sum(s for s in sizes if s >= 0)
            sizes = [rest if s < 0 else s for s in sizes]
    return list(torch.split(x, sizes, axis))


def tensor_split(x, num_or_indices, axis=0, name=None):
    dim = x.shape[int(axis)]
    if isinstance(num_or_indices, int):
        base, extra = divmod(dim, num_or_indices)
        sizes = [base + (1 if i < extra else 0)
                 for i in range(num_or_indices)]
    else:
        idxs = [0] + ints(num_or_indices) + [dim]
        sizes = [idxs[i + 1] - idxs[i] for i in range(len(idxs) - 1)]
    return split(x, sizes, axis)


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@gated("squeeze")
def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        return torch.squeeze(x, tuple(int(a) for a in axis))
    return torch.squeeze(x, int(axis))


def squeeze_(x, axis=None, name=None):
    return write(x, squeeze(x, axis))


@gated("unsqueeze")
def unsqueeze(x, axis, name=None):
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist() if axis.dim() else int(axis.item())
    if isinstance(axis, (list, tuple)):
        out = x
        for a in axis:
            out = torch.unsqueeze(out, int(a))
        return out
    return torch.unsqueeze(x, int(axis))


def unsqueeze_(x, axis, name=None):
    return write(x, unsqueeze(x, axis))


@gated("flatten")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, int(start_axis), int(stop_axis))


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return write(x, flatten(x, start_axis, stop_axis))


@gated("unflatten")
def unflatten(x, axis, shape, name=None):
    return torch.unflatten(x, int(axis), ints(shape))


@gated("expand")
def expand(x, shape, name=None):
    shape = ints(shape)
    cur = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    tgt = [c if s == -1 else s for s, c in zip(shape, cur)]
    return torch.broadcast_to(x.reshape(cur), tgt)


def expand_as(x, y, name=None):
    return expand(x, list(y.shape))


@gated("broadcast_to")
def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, ints(shape))


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[t.shape for t in inputs])
    return [broadcast_to(t, list(shape)) for t in inputs]


@gated("tile")
def tile(x, repeat_times, name=None):
    return torch.tile(x, ints(repeat_times))


@gated("flip")
def flip(x, axis, name=None):
    return torch.flip(x, ints(axis))


@gated("rot90")
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, int(k), ints(axes))


@gated("roll")
def roll(x, shifts, axis=None, name=None):
    shifts = ints(shifts) if isinstance(shifts, (list, tuple)) else int(
        scalar(shifts))
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, ints(axis) if isinstance(
        axis, (list, tuple)) else int(axis))


@gated("gather")
def gather(x, index, axis=0, name=None):
    axis = int(scalar(axis)) % x.dim()
    if index.dim() == 0:
        index = index[None]
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


@gated("gather_nd")
def gather_nd(x, index, name=None):
    k = index.shape[-1]
    flat = index.reshape(-1, k)
    out = x[tuple(flat[:, i] for i in range(k))]
    return out.reshape(tuple(index.shape[:-1]) + tuple(x.shape[k:]))


def _last_of_duplicates(index, n):
    """A mask keeping, of each index, its last occurrence."""
    pos = torch.arange(index.numel(), device=index.device)
    last = torch.full((n,), -1, dtype=pos.dtype, device=index.device)
    last.scatter_reduce_(0, index, pos, "amax")
    return pos == last[index]


@gated("scatter")
def scatter(x, index, updates, overwrite=True, name=None):
    """Rows `index` of `x` set to (or, without `overwrite`, increased
    by) `updates`.  As in JAX (``mode="drop"``): a negative index counts
    from the end, an index still out of range is dropped, and of
    duplicate indices the last row is written."""
    if index.dim() == 2:
        index = index[:, 0]
    n = x.shape[0]
    index = torch.where(index < 0, index + n, index)
    keep = (index >= 0) & (index < n)
    index, updates = index[keep], updates[keep]
    out = x.clone()
    if overwrite:
        last = _last_of_duplicates(index, n)
        out[index[last]] = updates[last].to(x.dtype)
        return out
    return out.index_add_(0, index, updates.to(x.dtype))


def scatter_(x, index, updates, overwrite=True, name=None):
    return write(x, scatter(x, index, updates, overwrite))


@gated("scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    k = index.shape[-1]
    flat = index.reshape(-1, k)
    upd = updates.reshape((-1,) + tuple(x.shape[k:]))
    return x.index_put(tuple(flat[:, i] for i in range(k)), upd.to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(ints(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


@gated("index_select")
def index_select(x, index, axis=0, name=None):
    return torch.index_select(x, int(scalar(axis)), index)


@gated("index_sample")
def index_sample(x, index):
    return torch.gather(x, 1, index.to(I64))


@gated("index_add")
def index_add(x, index, axis, value, name=None):
    return torch.index_add(x, int(axis), index, value.to(x.dtype))


@gated("index_put")
def index_put(x, indices, value, accumulate=False, name=None):
    value = tensor(value, x).to(x.dtype)
    return x.index_put(tuple(indices), value, accumulate=bool(accumulate))


@gated("getitem")
def getitem(x, index):
    return x[index]


@gated("masked_select")
def masked_select(x, mask, name=None):
    xb, mb = torch.broadcast_tensors(x, mask)
    return xb[mb]


@gated("masked_fill")
def masked_fill(x, mask, value, name=None):
    return torch.where(mask, tensor(value, x).to(x.dtype), x)


@gated("masked_scatter")
def masked_scatter(x, mask, value, name=None):
    flat_m = torch.broadcast_to(mask, x.shape).reshape(-1)
    flat_v = value.reshape(-1)
    pos = torch.cumsum(flat_m.to(I64), 0) - 1
    src = flat_v[torch.clamp(pos, 0, flat_v.shape[0] - 1)]
    return torch.where(flat_m, src.to(x.dtype), x.reshape(-1)).reshape(
        x.shape)


@gated("where")
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return tuple(torch.nonzero(condition, as_tuple=True))
    if not isinstance(x, torch.Tensor):
        x = tensor(x, y if isinstance(y, torch.Tensor) else condition)
    if not isinstance(y, torch.Tensor):
        y = tensor(y, x)
    return torch.where(condition, x, y)


@gated("nonzero")
def nonzero(x, as_tuple=False):
    if as_tuple:
        return tuple(o[:, None] for o in torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


@gated("take")
def take(x, index, mode="raise", name=None):
    flat = x.reshape(-1)
    n = flat.shape[0]
    if mode == "wrap":
        idx = torch.remainder(index, n)
    elif mode == "clip":
        idx = torch.clamp(index, 0, n - 1)
    else:
        idx = torch.where(index < 0, index + n, index)
    return flat[idx.reshape(-1)].reshape(index.shape)


@gated("take_along_axis")
def take_along_axis(x, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(x, indices.to(I64), int(axis))


@gated("put_along_axis")
def put_along_axis(x, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    values = torch.broadcast_to(tensor(values, x, x.dtype).to(x.dtype),
                                indices.shape).contiguous()
    axis, indices = int(axis), indices.to(I64)
    if reduce in ("add", "sum"):
        return torch.scatter_add(x, axis, indices, values)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(x, axis, indices, values, "prod")
    return torch.scatter(x, axis, indices, values)


@gated("one_hot")
def one_hot(x, num_classes, name=None):
    return _F.one_hot(x.to(I64), int(num_classes)).to(torch.float32)


@gated("topk")
def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The k largest (smallest) along `axis`; of equal values the lower
    index first, as `jax.lax.top_k` orders them (a stable sort: torch's
    `topk` fixes no order among ties)."""
    k = int(scalar(k))
    ax = -1 if axis is None else int(axis)
    vals, idxs = torch.sort(x, dim=ax, descending=largest, stable=True)
    return vals.narrow(ax, 0, k), idxs.narrow(ax, 0, k).to(I64)


@gated("sort")
def sort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(x, dim=int(axis), descending=descending,
                      stable=True).values


@gated("argsort")
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    # JAX: the stable ascending order, flipped for descending (ties then
    # come last index first)
    out = torch.sort(x, dim=int(axis), stable=True).indices
    if descending:
        out = torch.flip(out, (int(axis),))
    return out.to(I64)


@gated("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    out = torch.searchsorted(sorted_sequence.contiguous(),
                             values.contiguous(), right=right)
    return out.to(torch.int32 if out_int32 else I64)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """`np.unique` on the device: the sorted unique values (rows along
    `axis`), the index of each one's first occurrence, the inverse and
    the counts, as int64."""
    v = x.reshape(-1) if axis is None else x
    dim = 0 if axis is None else int(axis)
    out, inv, counts = torch.unique(v, sorted=True, return_inverse=True,
                                    return_counts=True, dim=dim)
    res = [out]
    if return_index:
        pos = torch.arange(v.shape[dim], device=x.device)
        first = torch.full((out.shape[dim],), v.shape[dim], dtype=pos.dtype,
                           device=x.device)
        res.append(first.scatter_reduce_(0, inv, pos, "amin").to(I64))
    if return_inverse:
        res.append(inv.reshape(-1).to(I64))
    if return_counts:
        res.append(counts.to(I64))
    return res[0] if len(res) == 1 else tuple(res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    v = x.reshape(-1) if axis is None else x
    out, inv, counts = torch.unique_consecutive(
        v, return_inverse=True, return_counts=True,
        dim=0 if axis is None else int(axis))
    res = [out]
    if return_inverse:
        res.append(inv.reshape(-1).to(I64))
    if return_counts:
        res.append(counts.to(I64))
    return res[0] if len(res) == 1 else tuple(res)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(x, int(axis)))


def _index(n, s, e, st=1):
    return list(range(*_pyslice(int(scalar(s)), int(scalar(e)),
                                int(scalar(st))).indices(n)))


@gated("slice")
def slice(x, axes, starts, ends):
    idx = [_pyslice(None)] * x.dim()
    for ax, s, e in zip(ints(axes), starts, ends):
        idx[ax] = _pyslice(int(scalar(s)), int(scalar(e)))
    return x[tuple(idx)]


@gated("strided_slice")
def strided_slice(x, axes, starts, ends, strides, name=None):
    out = x
    for ax, s, e, st in zip(ints(axes), starts, ends, strides):
        idx = torch.tensor(_index(out.shape[ax], s, e, st), dtype=I64,
                           device=x.device)
        out = torch.index_select(out, ax, idx)
    return out


@gated("crop")
def crop(x, shape=None, offsets=None, name=None):
    offsets = ints(offsets) if offsets is not None else [0] * x.dim()
    shape = ints(shape) if shape is not None else list(x.shape)
    out = x
    for i, (o, s) in enumerate(zip(offsets, shape)):
        out = out.narrow(i, o, x.shape[i] - o if s == -1 else s)
    return out


def _pad_cfg(pad, nd, data_format):
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    if len(pad) == 4 and nd == 4:
        if data_format == "NCHW":
            return [(0, 0), (0, 0), (pad[2], pad[3]), (pad[0], pad[1])]
        return [(0, 0), (pad[2], pad[3]), (pad[0], pad[1]), (0, 0)]
    if len(pad) == 6 and nd == 5:
        if data_format == "NCDHW":
            return [(0, 0), (0, 0), (pad[4], pad[5]), (pad[2], pad[3]),
                    (pad[0], pad[1])]
        return [(0, 0), (pad[4], pad[5]), (pad[2], pad[3]), (pad[0], pad[1]),
                (0, 0)]
    if len(pad) == 2 and nd == 3:
        if data_format == "NCL":
            return [(0, 0), (0, 0), (pad[0], pad[1])]
        return [(0, 0), (pad[0], pad[1]), (0, 0)]
    return [(0, 0)] * (nd - len(pad) // 2) + \
        [(pad[2 * i], pad[2 * i + 1]) for i in range(len(pad) // 2)]


@gated("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    cfg = _pad_cfg(ints(pad), x.dim(), data_format)
    if mode == "constant":
        flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
        return _F.pad(x, flat, "constant", value)
    npmode = {"reflect": "reflect", "replicate": "edge",
              "circular": "wrap"}[mode]
    out = x
    for ax, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = np.pad(np.arange(out.shape[ax]), (lo, hi), mode=npmode)
            out = torch.index_select(out, ax, torch.as_tensor(
                idx, dtype=I64, device=x.device))
    return out


@gated("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    if not isinstance(repeats, torch.Tensor):
        repeats = int(repeats)
    return torch.repeat_interleave(x, repeats, int(axis))


@gated("shard_index")
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(input, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(input, shard_size),
                       torch.full_like(input, ignore_value))


@gated("as_complex")
def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


@gated("as_real")
def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], -1)


@gated("atleast_1d")
def atleast_1d(x, name=None):
    return torch.atleast_1d(x)


@gated("atleast_2d")
def atleast_2d(x, name=None):
    return torch.atleast_2d(x)


@gated("atleast_3d")
def atleast_3d(x, name=None):
    return torch.atleast_3d(x)


@gated("tensordot")
def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = [ints(a) if isinstance(a, (list, tuple)) else a for a in axes]
    return torch.tensordot(x, y, dims=axes)


@gated("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, int(offset), int(axis1), int(axis2))


@gated("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, int(offset), int(axis1), int(axis2)).sum(-1)


@gated("kron")
def kron(x, y, name=None):
    return torch.kron(x, y)


@gated("renorm")
def renorm(x, p, axis, max_norm, name=None):
    dims = tuple(i for i in range(x.dim()) if i != int(axis) % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=I64, device=x.device)


def rank(x):
    return torch.tensor(x.dim(), dtype=I64, device=x.device)


def shape_op(x):
    return torch.tensor(list(x.shape), dtype=I64, device=x.device)


def tolist(x):
    return x.tolist()
