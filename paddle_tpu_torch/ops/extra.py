"""Long-tail tensor ops (``paddle_tpu/ops/extra.py`` counterpart).

The random ones draw from the port's per-device generators (`core.rng`,
C2.11): `standard_gamma` and `dirichlet` by Marsaglia-Tsang rejection
over those draws (torch's own gamma sampler takes no generator).
`edit_distance`, `gather_tree` and `auc` run on the host, as the JAX
package runs them (numpy loops), and return their results on the
input's device.
"""
from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core import rng as _rng
from ..core.device import resolve_device
from ._common import I64, gated, ints, scalar

__all__ = [
    "mm", "floor_mod", "reverse", "frexp", "gammaln", "multigammaln",
    "i0e", "i1", "i1e", "polar", "signbit", "nanquantile",
    "cumulative_trapezoid", "combinations", "broadcast_shape",
    "create_tensor", "is_complex", "is_floating_point", "is_integer",
    "diag_embed", "diagonal_scatter", "dsplit", "hsplit", "vsplit",
    "split_with_num", "index_fill", "fill", "fill_diagonal", "multiplex",
    "select_scatter", "slice_scatter", "unstack", "as_strided",
    "top_p_sampling", "uniform_", "normal_", "exponential_", "cauchy_",
    "geometric_",
    "addmm", "tril_indices", "triu_indices", "clip_by_norm",
    "fill_diagonal_tensor", "identity_loss", "temporal_shift", "gaussian",
    "standard_gamma", "binomial", "dirichlet", "edit_distance",
    "viterbi_decode", "gather_tree", "auc",
]


# ---------------------------- aliases ----------------------------

def mm(input, mat2, name=None):
    from .linalg import matmul

    return matmul(input, mat2)


def floor_mod(x, y, name=None):
    from .math import mod

    return mod(x, y)


def reverse(x, axis, name=None):
    from .manipulation import flip

    return flip(x, axis)


# ---------------------------- math ----------------------------

@gated("frexp")
def frexp(x, name=None):
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


@gated("gammaln")
def gammaln(x, name=None):
    return torch.lgamma(x)


@gated("multigammaln")
def multigammaln(x, p, name=None):
    const = 0.25 * p * (p - 1) * _math.log(_math.pi)
    terms = [torch.lgamma(x - 0.5 * i) for i in range(p)]
    return const + sum(terms[1:], terms[0])


@gated("i0e")
def i0e(x, name=None):
    return torch.special.i0e(x)


@gated("i1")
def i1(x, name=None):
    return torch.special.i1(x)


@gated("i1e")
def i1e(x, name=None):
    return torch.special.i1e(x)


@gated("polar")
def polar(abs, angle, name=None):
    return torch.complex(abs * torch.cos(angle), abs * torch.sin(angle))


@gated("signbit")
def signbit(x, name=None):
    return torch.signbit(x)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    from .reduction import _quantile

    return _quantile(x, q, axis, keepdim, interpolation, True)


@gated("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    n = y.shape[axis]
    lo, hi = y.narrow(axis, 0, n - 1), y.narrow(axis, 1, n - 1)
    if x is not None:
        widths = x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1)
    else:
        widths = dx if dx is not None else 1.0
    return torch.cumsum((lo + hi) * 0.5 * widths, axis)


def combinations(x, r=2, with_replacement=False, name=None):
    return torch.combinations(x, int(r), with_replacement)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def create_tensor(dtype="float32", name=None, persistable=False):
    return torch.zeros((0,), dtype=_dtypes.convert_dtype(dtype),
                       device=resolve_device(None))


def _dtype_of(x):
    return x.dtype if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.asarray(x)).dtype


def is_complex(x):
    return _dtype_of(x).is_complex


def is_floating_point(x):
    return _dtype_of(x).is_floating_point


def is_integer(x):
    dt = _dtype_of(x)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


# ---------------------------- manipulation ----------------------------

@gated("diag_embed")
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(input, int(offset), int(dim1), int(dim2))


@gated("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal_scatter(x, y.to(x.dtype), int(offset), int(axis1),
                                  int(axis2))


def _nsplit(x, num_or_sections, axis, min_ndim, api):
    if x.dim() < min_ndim:
        raise ValueError(f"{api} expects at least {min_ndim}-D input, "
                         f"got {x.dim()}-D")
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(f"{api}: axis {axis} length {x.shape[axis]} "
                             f"is not divisible by {num_or_sections}")
        return list(torch.tensor_split(x, num_or_sections, axis))
    points = np.cumsum(ints(num_or_sections)[:-1]).tolist()
    return list(torch.tensor_split(x, points, axis))


def vsplit(x, num_or_sections, name=None):
    return _nsplit(x, num_or_sections, 0, 2, "vsplit")


def hsplit(x, num_or_sections, name=None):
    return _nsplit(x, num_or_sections, 1, 2, "hsplit")


def dsplit(x, num_or_sections, name=None):
    return _nsplit(x, num_or_sections, 2, 3, "dsplit")


def split_with_num(x, num, axis=0, name=None):
    return _nsplit(x, num, axis, 1, "split_with_num")


@gated("index_fill")
def index_fill(x, index, axis, value, name=None):
    return torch.index_fill(x, int(axis), index, scalar(value))


@gated("fill")
def fill(x, value, name=None):
    return torch.full_like(x, scalar(value))


def _diag_rc(h, w, offset, device):
    k = min(h, w - offset) if offset >= 0 else min(h + offset, w)
    rows = torch.arange(k, device=device) + max(0, -offset)
    cols = torch.arange(k, device=device) + max(0, offset)
    return rows, cols


@gated("fill_diagonal")
def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    rows, cols = _diag_rc(x.shape[-2], x.shape[-1], int(offset), x.device)
    out = x.clone()
    out[..., rows, cols] = scalar(value)
    return out


def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs))
    sel = index.reshape(-1).to(I64)
    return stacked[sel, torch.arange(stacked.shape[1], device=sel.device)]


@gated("select_scatter")
def select_scatter(x, values, axis, index, name=None):
    return torch.select_scatter(x, values.to(x.dtype), int(axis), int(index))


@gated("slice_scatter")
def slice_scatter(x, value, axes=None, starts=None, ends=None, strides=None,
                  name=None):
    axes = axes or []
    idx = [slice(None)] * x.dim()
    for a, s, e, st in zip(axes, starts or [], ends or [],
                           strides or [1] * len(axes)):
        idx[a % x.dim()] = slice(s, e, st)
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(x, int(axis)))


@gated("as_strided")
def as_strided(x, shape, stride, offset=0, name=None):
    """A strided view of the flattened buffer, copied (the JAX package
    gathers: its arrays have no aliasing views)."""
    flat = x.contiguous().reshape(-1)
    return torch.as_strided(flat, ints(shape), ints(stride),
                            int(offset)).clone()


def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1,
                   k=0, mode="truncated", return_top=False, name=None):
    """Nucleus sampling over the last axis: keep the smallest prefix of
    descending-probability tokens whose mass reaches p (the top token
    always), renormalise, draw one id a row from the device's generator.
    Returns (probs of the drawn ids, ids)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    sorted_p = torch.gather(x, -1, order)
    cum = torch.cumsum(sorted_p, -1)
    keep = cum - sorted_p < ps.reshape(-1, 1)
    keep[..., 0] = True
    filtered = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    filtered = filtered / filtered.sum(-1, keepdim=True)
    choice = torch.multinomial(filtered.reshape(-1, x.shape[-1]), 1,
                               generator=_rng.generator(x.device))
    ids = torch.gather(order.reshape(-1, x.shape[-1]), -1, choice).reshape(
        x.shape[:-1] + (1,))
    return torch.gather(x, -1, ids), ids.to(I64)


# ------------------------ in-place random fills ------------------------

def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return x.uniform_(float(min), float(max),
                      generator=_rng.generator(x.device))


def normal_(x, mean=0.0, std=1.0, name=None):
    return x.normal_(float(mean), float(std),
                     generator=_rng.generator(x.device))


def exponential_(x, lam=1.0, name=None):
    return x.exponential_(float(lam), generator=_rng.generator(x.device))


def cauchy_(x, loc=0, scale=1, name=None):
    return x.cauchy_(float(loc), float(scale),
                     generator=_rng.generator(x.device))


def geometric_(x, probs, name=None):
    return x.geometric_(float(scalar(probs)),
                        generator=_rng.generator(x.device))


# ------------------- math / indexing -------------------

@gated("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * (x @ y)


def _tri_indices(f, row, col, offset, dtype):
    col = row if col is None else col
    return f(int(row), int(col), int(offset), device=resolve_device(None)).to(
        _dtypes.convert_dtype(dtype))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    return _tri_indices(torch.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _tri_indices(torch.triu_indices, row, col, offset, dtype)


@gated("clip_by_norm")
def clip_by_norm(x, max_norm, name=None):
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return x * torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


@gated("fill_diagonal_tensor")
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    nd = x.dim()
    a1, a2 = dim1 % nd, dim2 % nd
    moved = torch.movedim(x, (a1, a2), (nd - 2, nd - 1)).clone()
    rows, cols = _diag_rc(moved.shape[-2], moved.shape[-1], int(offset),
                          x.device)
    moved[..., rows, cols] = y.to(x.dtype)
    return torch.movedim(moved, (nd - 2, nd - 1), (a1, a2))


@gated("identity_loss")
def identity_loss(x, reduction="none", name=None):
    red = {"none": lambda v: v, 0: lambda v: v,
           "sum": torch.sum, 1: torch.sum,
           "mean": torch.mean, 2: torch.mean}
    return red[reduction](x)


@gated("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    pad = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 0, 1, 1))
    out = torch.cat([pad[:, :seg_num, :c1], pad[:, 2:, c1:c2], v[:, :, c2:]],
                    2).reshape(nt, c, h, w)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out


# ------------------- random sampling creation ops -------------------

def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype="float32", name=None,
             *, place=None):
    dev = resolve_device(place)
    z = torch.randn(ints(shape), dtype=_dtypes.convert_dtype(dtype),
                    device=dev, generator=_rng.generator(dev))
    return mean + std * z


def _gamma(alpha):
    """Gamma(alpha, 1) by Marsaglia-Tsang rejection (alpha < 1 boosted
    by U^(1/alpha)), drawing from the device's generator."""
    gen = _rng.generator(alpha.device)
    a = alpha.to(torch.float32)
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    done = torch.zeros_like(a, dtype=torch.bool)
    while not bool(done.all()):
        z = torch.randn(a.shape, generator=gen, device=a.device)
        u = torch.rand(a.shape, generator=gen, device=a.device)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
    u = torch.rand(a.shape, generator=gen, device=a.device)
    out = torch.where(boost, out * u ** (1.0 / a), out)
    return out.to(alpha.dtype)


def standard_gamma(x, name=None):
    return _gamma(x)


def binomial(count, prob, name=None):
    return torch.binomial(count.to(prob.dtype), prob,
                          generator=_rng.generator(prob.device)).to(I64)


def dirichlet(alpha, name=None):
    g = _gamma(alpha)
    return g / g.sum(-1, keepdim=True)


# ------------------- host-side sequence / metric ops -------------------

def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance per batch row, on the host as the JAX
    package computes it (JAX :482); ([B, 1] f32, [B, 1] int64)."""
    a, b = _host(input), _host(label)
    la = _host(input_length) if input_length is not None \
        else np.full(a.shape[0], a.shape[1])
    lb = _host(label_length) if label_length is not None \
        else np.full(b.shape[0], b.shape[1])
    ignored = set(ignored_tokens or ())
    dists = np.zeros((a.shape[0], 1), np.float32)
    counts = np.zeros((a.shape[0], 1), np.int64)
    for i in range(a.shape[0]):
        s1 = [t for t in a[i, :int(la[i])] if t not in ignored]
        s2 = [t for t in b[i, :int(lb[i])] if t not in ignored]
        m, n = len(s1), len(s2)
        dp = np.arange(n + 1, dtype=np.float32)
        for r in range(1, m + 1):
            prev = dp.copy()
            dp[0] = r
            for c in range(1, n + 1):
                dp[c] = min(prev[c] + 1, dp[c - 1] + 1,
                            prev[c - 1] + (s1[r - 1] != s2[c - 1]))
        d = dp[n]
        dists[i, 0] = d / max(1, n) if normalized else d
        counts[i, 0] = max(1, n)
    dev = input.device if isinstance(input, torch.Tensor) else None
    return (torch.from_numpy(dists).to(dev),
            torch.from_numpy(counts).to(dev))


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """CRF Viterbi decoding (JAX :514): the best score and tag path of
    each row; `lengths` is not read, as in JAX."""
    emis, trans = potentials, transition_params
    b, t, n = emis.shape
    alpha = emis[:, 0] + trans[n - 2][None, :] if include_bos_eos_tag \
        else emis[:, 0]
    bps = []
    for i in range(1, t):
        scores = alpha[:, :, None] + trans[None, :, :]
        bps.append(torch.argmax(scores, 1))
        alpha = torch.amax(scores, 1) + emis[:, i]
    if include_bos_eos_tag:
        alpha = alpha + trans[:, n - 1][None, :]
    best = torch.amax(alpha, -1)
    cur = torch.argmax(alpha, -1)
    path = [cur]
    for bp in reversed(bps):
        cur = torch.gather(bp, 1, cur[:, None])[:, 0]
        path.append(cur)
    return best, torch.stack(path[::-1], 1).to(I64)


def gather_tree(ids, parents, name=None):
    """Beam-search backtrace (JAX :556): follow the parent pointers from
    the last step back to the root, on the host."""
    iv, pv = _host(ids), _host(parents)
    t, b, w = iv.shape
    out = np.zeros_like(iv)
    for bi in range(b):
        for wi in range(w):
            beam = wi
            for ti in range(t - 1, -1, -1):
                out[ti, bi, wi] = iv[ti, bi, beam]
                beam = int(pv[ti, bi, beam])
    return torch.from_numpy(out).to(ids.device)


def auc(x, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    """Batch ROC AUC by the trapezoid rule over the sorted scores (JAX
    :573), on the host."""
    pred = _host(x)
    lab = _host(label).reshape(-1)
    score = pred[:, 1] if pred.ndim == 2 and pred.shape[1] == 2 \
        else pred.reshape(-1)
    lab = lab[np.argsort(-score)]
    tps, fps = np.cumsum(lab), np.cumsum(1 - lab)
    tpr = np.concatenate([[0.0], tps / max(1, int(tps[-1]))])
    fpr = np.concatenate([[0.0], fps / max(1, int(fps[-1]))])
    return torch.tensor(np.trapezoid(tpr, fpr), dtype=torch.float32,
                        device=x.device)

