"""Packed (varlen) attention: CUDA kernel wrappers, plain versions, and
the `VarlenAttention` autograd function over them.

Counterpart of ``paddle_tpu/ops/pallas/varlen_attention.py``: the
forward `_vl_fwd_kernel` :56 / `_vl_fwd` :105 and the backward `_vl_bwd`
:139 (`_vl_dq_kernel` :71, `_vl_dkv_kernel` :87) under the custom VJP
`_vl_core` :188.  The kernels are the packed mode of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (a template flag; the
dense instantiations are unchanged), with wrappers and launch counters
of their own.  `cu_seqlens` stay on the device: each tile of the packed
axis finds its segments by binary search, so a launch costs no host
sync (`flash_attn_unpadded`'s causal packing check does sync).

Semantics of the JAX function kept here: position t belongs to segment
``searchsorted(cu, t, side="right") - 1`` (repeated entries are empty
sequences); q segment i attends k segment i; causal is JAX's one global
diagonal (key j visible to query i when j <= i + Tk - Tq), which is
per-sequence causal when the two packings are equal; no GQA (the JAX
kernel indexes K/V by the query head).  Two deliberate differences:
`scale` is applied in f32 inside the kernel (JAX folds ``scale *
sqrt(d)`` into q in q's dtype, one more bf16 rounding), and a row that
sees no key writes zeros with the finite LSE -1e30 (JAX averages the
padded value rows of its block there).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _op

NEG_INF = -1e30
SOURCE = "paddle_tpu_torch/csrc/flash_fwd.cu"
REPLACES = ("paddle_tpu/ops/pallas/varlen_attention.py:56 "
            "(_vl_fwd_kernel, via _vl_fwd :105)")
BWD_SOURCE = "paddle_tpu_torch/csrc/flash_bwd.cu"
BWD_REPLACES = ("paddle_tpu/ops/pallas/varlen_attention.py:139 (_vl_bwd: "
                "_vl_dq_kernel :71, _vl_dkv_kernel :87)")

launches = 0        # varlen_fwd
bwd_launches = 0    # varlen_bwd

_SIG = {"varlen_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
_BWD_SIG = {"varlen_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bounds(cu, total):
    """Host list of segment starts for ids -1 .. n + 1 (JAX
    `segment_ids_from_cu_seqlens` :40: -1 before cu[0], n from cu[n] on):
    segment i holds positions [b[i + 1], b[i + 2])."""
    return [0] + [int(c) for c in cu.tolist()] + [total]


def _segments(q, k, cu_q, cu_k, causal):
    """Per segment id -1 .. n: (q rows, k rows, keep mask [sq, sk] of the
    global causal diagonal or None)."""
    tq, tk = q.shape[0], k.shape[0]
    bq, bk = _bounds(cu_q, tq), _bounds(cu_k, tk)
    off = tk - tq
    for i in range(len(bq) - 1):
        q0, q1, k0, k1 = bq[i], bq[i + 1], bk[i], bk[i + 1]
        if q1 <= q0:
            continue
        keep = None
        if causal and k1 > k0:
            qi = torch.arange(q0, q1, device=q.device)[:, None]
            kj = torch.arange(k0, k1, device=q.device)[None]
            keep = kj <= qi + off
        yield slice(q0, q1), slice(k0, k1), keep


def _probs(qs, ks, keep, scale):
    """f32 scores [H, sq, sk] of one segment, masked keys at -inf, and
    its LSE [H, sq] (-inf where a row sees no key)."""
    s = torch.einsum("qhd,khd->hqk", qs.float(), ks.float()) * scale
    if keep is not None:
        s = torch.where(keep, s, float("-inf"))
    return s, torch.logsumexp(s, dim=-1)


def _check_packing(fn, q, k, v, cu_q, cu_k):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected [T, H, D] each")
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"{fn}: {q.shape[1]} query heads over "
                         f"{k.shape[1]} kv heads; varlen attention has no "
                         "GQA (the JAX kernel indexes K/V by query head)")
    if cu_q.dim() != 1 or cu_q.shape != cu_k.shape or cu_q.numel() < 1:
        raise ValueError(f"{fn}: cu_seqlens {tuple(cu_q.shape)} / "
                         f"{tuple(cu_k.shape)}; expected [n + 1] each")


def varlen_fwd_reference(q, k, v, cu_q, cu_k, scale=None, causal=False):
    """Plain version, one segment at a time: (out [Tq, H, D] in q's
    dtype, lse [H, Tq] f32).  Rows that see no key: zeros, LSE -1e30."""
    _check_packing("varlen_fwd", q, k, v, cu_q, cu_k)
    tq, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.zeros(tq, h, d, dtype=torch.float32, device=q.device)
    lse = torch.full((h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    for sq, sk, keep in _segments(q, k, cu_q, cu_k, causal):
        if sk.stop <= sk.start:
            continue
        s, l = _probs(q[sq], k[sk], keep, scale)
        seen = torch.isfinite(l)
        p = torch.where(seen[..., None], torch.exp(s - l[..., None]), 0.0)
        out[sq] = torch.einsum("hqk,khd->qhd", p, v[sk].float())
        lse[:, sq] = torch.where(seen, l, NEG_INF)
    return out.to(q.dtype), lse


def varlen_bwd_reference(q, k, v, out, lse, dout, cu_q, cu_k, scale=None,
                         causal=False):
    """Plain version of the backward: (dq, dk, dv) in the inputs' dtypes,
    f32 between, one segment at a time: p = exp(scores - lse) from the
    saved LSE (0 outside the segment and past the diagonal), delta =
    rowsum(dO * O), ds = p * (dO.v - delta) * scale."""
    _check_packing("varlen_bwd", q, k, v, cu_q, cu_k)
    d = q.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    delta = (dout.float() * out.float()).sum(-1).t()             # [H, Tq]
    for sq, sk, keep in _segments(q, k, cu_q, cu_k, causal):
        if sk.stop <= sk.start:
            continue
        s, _ = _probs(q[sq], k[sk], keep, scale)
        p = torch.exp(s - lse[:, sq, None])                   # 0 at -inf
        do = dout[sq].float()
        dp = torch.einsum("qhd,khd->hqk", do, v[sk].float())
        ds = p * (dp - delta[:, sq, None]) * scale
        dq[sq] = torch.einsum("hqk,khd->qhd", ds, k[sk].float())
        dk[sk] = torch.einsum("hqk,qhd->khd", ds, q[sq].float())
        dv[sk] = torch.einsum("hqk,qhd->khd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(fn, q, k, v, cu_q, cu_k):
    """What the packed kernels take: q [Tq,H,D], k/v [Tk,H,D] with D % 8
    == 0 and D <= 256, f32, bf16 or f16 alike, contiguous; cu_seqlens int32
    [n + 1] each, contiguous, all on q's CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    _check_packing(fn, q, k, v, cu_q, cu_k)
    tq, h, d = q.shape
    if d % 8 or d > 256:
        raise ValueError(f"{fn}: head_dim {d} must be a multiple of 8 "
                         "and <= 256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{fn}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "expected float32, bfloat16 or float16, all "
                        "alike")
    if cu_q.dtype != torch.int32 or cu_k.dtype != torch.int32:
        raise TypeError(f"{fn}: cu_seqlens must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("cu_seqlens_q", cu_q),
                    ("cu_seqlens_k", cu_k)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous on "
                             f"{q.device}")
    if tq == 0 or k.shape[0] == 0:
        raise ValueError(f"{fn}: empty packed batch")
    return tq, k.shape[0], h, d


def varlen_fwd(q, k, v, cu_q, cu_k, scale=None, causal=False):
    """q [Tq,H,D]; k/v [Tk,H,D]; cu_q / cu_k [n + 1] cumulative lengths.
    Returns (out [Tq,H,D], lse [H,Tq] f32).  The op
    ``paddle_tpu_torch::varlen_fwd``: CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    _op.check_device("varlen_fwd", q)
    return _varlen_fwd_op(q, k, v, cu_q, cu_k,
                          None if scale is None else float(scale),
                          bool(causal))


def _varlen_fwd_cuda(q, k, v, cu_q, cu_k, scale, causal):
    """The CUDA implementation of ``paddle_tpu_torch::varlen_fwd``."""
    global launches
    tq, tk, h, d = _check("varlen_fwd", q, k, v, cu_q, cu_k)
    out = torch.empty_like(q)
    lse = torch.empty(h, tq, device=q.device, dtype=torch.float32)
    lib = _build.library("flash_fwd", _SIG)
    err = lib.varlen_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(cu_q),
        _build.ptr(cu_k), _build.ptr(out), _build.ptr(lse),
        cu_q.numel() - 1, tq, tk, h, d, int(bool(causal)),
        1.0 / math.sqrt(d) if scale is None else float(scale),
        _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "varlen_fwd")
    launches += 1
    return out, lse


def _varlen_fwd_fake(q, k, v, cu_q, cu_k, scale, causal):
    return torch.empty_like(q), q.new_empty((q.shape[1], q.shape[0]),
                                            dtype=torch.float32)


_varlen_fwd_op = _op.define(
    "varlen_fwd", "(Tensor q, Tensor k, Tensor v, Tensor cu_q, Tensor cu_k, "
    "float? scale, bool causal) -> (Tensor, Tensor)", varlen_fwd_reference,
    _varlen_fwd_cuda, _varlen_fwd_fake)


def varlen_bwd(q, k, v, out, lse, dout, cu_q, cu_k, scale=None,
               causal=False):
    """Gradients of varlen_fwd: q/out/dout [Tq,H,D], k/v [Tk,H,D], lse
    [H,Tq] f32 (varlen_fwd's), the packing, scale and causal as given to
    it.  Returns (dq, dk, dv).  CPU tensors run the plain version; CUDA
    tensors launch the kernels (dQ, then dK/dV) or raise."""
    global bwd_launches
    if q.device.type == "cpu":
        return varlen_bwd_reference(q, k, v, out, lse, dout, cu_q, cu_k,
                                    scale, causal)
    tq, tk, h, d = _check("varlen_bwd", q, k, v, cu_q, cu_k)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"varlen_bwd: {name} must be a contiguous "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
    if lse.shape != (h, tq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"varlen_bwd: lse must be a contiguous float32 "
                         f"{(h, tq)} on {q.device}")
    delta = torch.empty(h, tq, device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    lib = _build.library("flash_bwd", _BWD_SIG)
    err = lib.varlen_bwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse), _build.ptr(dout), _build.ptr(cu_q),
        _build.ptr(cu_k), _build.ptr(delta), _build.ptr(dq), _build.ptr(dk),
        _build.ptr(dv), cu_q.numel() - 1, tq, tk, h, d, int(bool(causal)),
        1.0 / math.sqrt(d) if scale is None else float(scale),
        _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "varlen_bwd")
    bwd_launches += 1
    return dq, dk, dv


class VarlenAttention(torch.autograd.Function):
    """out = varlen attention(q, k, v) through `varlen_fwd`,
    differentiated by `varlen_bwd` (the `_vl_core` custom VJP).  The
    packing gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, scale=None, causal=False):
        out, lse = varlen_fwd(q, k, v, cu_q, cu_k, scale=scale,
                              causal=causal)
        ctx.save_for_backward(q, k, v, out, lse, cu_q, cu_k)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, cu_q, cu_k = ctx.saved_tensors
        dq, dk, dv = varlen_bwd(q, k, v, out, lse, dout.contiguous(), cu_q,
                                cu_k, scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None, None, None
