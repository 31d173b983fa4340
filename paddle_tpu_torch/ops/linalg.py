"""Linear algebra ops (``paddle_tpu/ops/linalg.py`` counterpart) over
``torch.linalg``.  `matmul` (:27) is white-listed under `amp.auto_cast`,
which casts both operands to the AMP dtype.

Decompositions keep the JAX outputs' layout (`svd` returns V, not Vᴴ;
`lu` 1-based pivots; `slogdet` one stacked tensor); where a
decomposition is unique only up to signs or order (`svd`, `eig`,
`eigh`, `qr`) the port's factors reconstruct the same matrix as JAX's.
`lstsq` and `histogram` are written out as the JAX bodies compute them
(the same rank, residuals and edge rule on every device).
"""
from __future__ import annotations

import numpy as np
import torch

from ._common import I64, axes, gated, ints, scalar

__all__ = [
    "matmul", "dot", "bmm", "mv", "t", "norm", "dist", "einsum", "cross",
    "cholesky", "cholesky_solve", "qr", "svd", "pca_lowrank", "matrix_rank",
    "inverse", "pinv", "solve", "triangular_solve", "lstsq", "lu",
    "lu_unpack", "eig", "eigh", "eigvals", "eigvalsh", "slogdet", "det",
    "matrix_power", "multi_dot", "histogram", "histogramdd", "bincount",
    "cov", "corrcoef", "cdist", "householder_product", "matrix_exp",
    "vander", "vecdot", "cond_number", "svdvals", "vector_norm",
    "matrix_norm", "ormqr",
]


@gated("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y, each optionally transposed over its last two axes (a 1-D
    operand is not transposed)."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@gated("dot")
def dot(x, y, name=None):
    return torch.sum(x * y, -1)


@gated("bmm")
def bmm(x, y, name=None):
    return torch.bmm(x, y)


@gated("mv")
def mv(x, vec, name=None):
    return torch.matmul(x, vec)


@gated("t")
def t(x, name=None):
    if x.dim() < 2:
        return x
    return x.transpose(0, 1)


@gated("norm")
def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    dim = axes(axis)
    if dim is None:
        dim = tuple(range(x.dim()))
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(torch.abs(x)), dim,
                                    keepdim=keepdim))
    if p == "nuc":
        s = torch.linalg.svdvals(x)
        return torch.sum(s, -1, keepdim=keepdim)
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim, keepdim=keepdim) ** (1.0 / p)


@gated("dist")
def dist(x, y, p=2, name=None):
    d = torch.abs(x - y)
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    if p == float("inf"):
        return torch.amax(d)
    if p == float("-inf"):
        return torch.amin(d)
    return torch.sum(d ** p) ** (1.0 / p)


@gated("einsum")
def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


@gated("cross")
def cross(x, y, axis=9, name=None):
    if axis == 9:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=int(axis))


@gated("cholesky")
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


@gated("cholesky_solve")
def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(x, y, upper=upper)


@gated("qr")
def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


@gated("svd")
def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.mH


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    m, n = x.shape[-2], x.shape[-1]
    if q is None:
        q = min(6, m, n)
    if center:
        x = x - torch.mean(x, -2, keepdim=True)
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    return u[..., :q], s[..., :q], vh.mH[..., :q]


@gated("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(x, rtol=tol).to(I64)


@gated("inverse")
def inverse(x, name=None):
    return torch.linalg.inv(x)


@gated("pinv")
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@gated("solve")
def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


@gated("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solves x @ out = y (xᵀ @ out = y with `transpose`)."""
    if transpose:
        x, upper = x.mT, not upper
    return torch.linalg.solve_triangular(x, y, upper=upper, left=True,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """Least squares through the SVD, as `jnp.linalg.lstsq` computes it:
    singular values below ``rcond * s_max`` (rcond eps * max(m, n) when
    None) are dropped; (solution, residuals, rank, singular values),
    residuals empty unless the rank is full and m > n."""
    m, n = x.shape[-2], x.shape[-1]
    vec = y.dim() == x.dim() - 1
    b = y.unsqueeze(-1) if vec else y
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * max(m, n)
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    mask = s >= rcond * s[..., :1]
    rank = mask.sum(-1)
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    sol = vh.mH @ (s_inv.unsqueeze(-1) * (u.mH @ b))
    if int(rank.min()) == n and m > n:
        resid = torch.sum(torch.abs(b - x @ sol) ** 2, -2)
    else:
        resid = torch.empty((0,), dtype=x.dtype, device=x.device)
    if vec:
        sol = sol.squeeze(-1)
        resid = resid.squeeze(-1) if resid.numel() else resid
    return sol, resid, rank.to(I64), s


@gated("lu")
def lu(x, pivot=True, get_infos=False, name=None):
    lu_, piv = torch.linalg.lu_factor(x)       # 1-based, as JAX returns
    piv = piv.to(torch.int32)
    if get_infos:
        return lu_, piv, torch.zeros(x.shape[:-2], dtype=torch.int32,
                                     device=x.device)
    return lu_, piv


@gated("lu_unpack")
def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    return torch.lu_unpack(lu_data, lu_pivots.to(torch.int32))


def eig(x, name=None):
    return torch.linalg.eig(x)


@gated("eigh")
def eigh(x, UPLO="L", name=None):
    # JAX symmetrizes the input (symmetrize_input=True)
    w, v = torch.linalg.eigh((x + x.mH) / 2)
    return w, v


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


@gated("eigvalsh")
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh((x + x.mH) / 2)


@gated("slogdet")
def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@gated("det")
def det(x, name=None):
    return torch.linalg.det(x)


@gated("matrix_power")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, int(n))


@gated("multi_dot")
def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


def _edges_index(a, edges, last_dim_rule):
    idx = torch.searchsorted(edges, a.contiguous(), right=True)
    return torch.where(a == edges[-1], last_dim_rule(idx), idx)


@gated("histogram")
def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    a = input.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = torch.amin(a), torch.amax(a)
    else:
        lo, hi = (torch.tensor(float(v), dtype=a.dtype, device=a.device)
                  for v in (min, max))
    fl = a.dtype if a.is_floating_point() else torch.float32
    edges = lo.to(fl) + (hi - lo).to(fl) * torch.linspace(
        0, 1, bins + 1, dtype=fl, device=a.device)
    edges[-1] = hi
    idx = _edges_index(a.to(fl), edges, lambda i: torch.full_like(i, bins))
    w = (torch.ones_like(a, dtype=fl) if weight is None
         else weight.reshape(-1).to(fl))
    counts = torch.zeros(bins + 2, dtype=fl, device=a.device).index_add_(
        0, idx, w)[1:bins + 1]
    if density:
        return counts / torch.diff(edges) / counts.sum()
    return counts if weight is not None else counts.to(I64)


@gated("histogramdd")
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    n, d = x.shape
    nb = [bins] * d if isinstance(bins, int) else ints(bins)
    if ranges is None:
        rg = [(x[:, i].amin(), x[:, i].amax()) for i in range(d)]
    else:
        flat = np.asarray(ranges, float).reshape(-1, 2)
        rg = [tuple(torch.tensor(v, dtype=x.dtype, device=x.device)
                    for v in p) for p in flat]
    edges, flat_idx = [], torch.zeros(n, dtype=I64, device=x.device)
    for i in range(d):
        e = torch.linspace(0, 1, nb[i] + 1, dtype=x.dtype, device=x.device)
        e = rg[i][0] + (rg[i][1] - rg[i][0]) * e
        edges.append(e)
        bi = _edges_index(x[:, i], e, lambda j: j - 1)
        flat_idx = flat_idx * (nb[i] + 2) + bi
    w = torch.ones(n, dtype=x.dtype, device=x.device) if weights is None \
        else weights.to(x.dtype)
    size = int(np.prod([b + 2 for b in nb]))
    hist = torch.zeros(size, dtype=x.dtype, device=x.device).index_add_(
        0, flat_idx, w).reshape([b + 2 for b in nb])
    hist = hist[tuple(slice(1, -1) for _ in range(d))]
    if density:
        s = hist.sum()
        for i in range(d):
            shape = [1] * d
            shape[i] = -1
            hist = hist / torch.diff(edges[i]).reshape(shape)
        hist = hist / s
    elif weights is None:
        hist = hist.to(I64)
    return hist, edges


@gated("bincount")
def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(x.reshape(-1), weights, int(minlength))
    return out.to(weights.dtype) if weights is not None else out


@gated("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.mT, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


@gated("corrcoef")
def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.mT)


@gated("cdist")
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    d = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.sum(d * d, -1) + 1e-30)
    if p == float("inf"):
        return torch.amax(torch.abs(d), -1)
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


@gated("householder_product")
def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(x, tau)


@gated("matrix_exp")
def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(x)


@gated("vander")
def vander(x, n=None, increasing=False, name=None):
    out = torch.linalg.vander(x, N=n)
    return out if increasing else torch.flip(out, (-1,))


@gated("vecdot")
def vecdot(x, y, axis=-1, name=None):
    return torch.sum(x * y, int(axis))


@gated("cond")
def cond_number(x, p=None, name=None):
    return torch.linalg.cond(x, p)


@gated("svdvals")
def svdvals(x, name=None):
    return torch.linalg.svdvals(x)


@gated("vector_norm")
def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return torch.linalg.vector_norm(x, scalar(p), axes(axis), keepdim)


@gated("matrix_norm")
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return torch.linalg.matrix_norm(x, p, tuple(int(a) for a in axis),
                                    keepdim)


@gated("ormqr")
def ormqr(x, tau, other, left=True, transpose=False, name=None):
    return torch.ormqr(x, tau, other, left, transpose)
