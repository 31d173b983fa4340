"""Ragged paged-attention decode: CUDA kernel wrapper + plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``
(`_paged_kernel` :68, `paged_attention` :134,
`paged_attention_reference` :217).  The kernels are in
``csrc/paged_attention.cu``: `paged_attention` for f32 / bf16 / f16
pools (the exact tier) and `paged_attention_int8` for the quantized KV
tier's int8 pools with per-token, per-head f32 scale tables (q and the
output f32, bf16 or f16).  One wrapper serves
both; each kernel counts on its own counter.  Both kernels run the same
cluster-split core and copy the pools' rows 16 bytes a lane, so the
pools must start on a 16-byte boundary; the int8 kernel's scale tables
need no alignment (off a 16-byte boundary they move 4 bytes a row).
"""
from __future__ import annotations

import ctypes

import torch

from ..quant import dequantize_vectors
from . import _build

NEG_INF = -1e30
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:68 (_paged_kernel)"
INT8_REPLACES = ("paddle_tpu/ops/pallas/paged_attention.py:68 (_paged_kernel,"
                 " int8 branch: dequant :104-106, scale rows :189-193)")

launches = 0        # paged_attention (f32 / bf16 / f16 pools)
int8_launches = 0   # paged_attention_int8 (int8 pools + scale tables)

_SIG = {"paged_attention": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
_INT8_SIG = {"paged_attention_int8": [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _scales_pair(k_scales, v_scales):
    """True for the int8 tier (both tables), False for the exact tier."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_attention: k_scales and v_scales must be "
                         "given together")
    return k_scales is not None


def paged_attention_reference(q, k_pages, v_pages, page_table, pos,
                              k_scales=None, v_scales=None):
    """Plain version: gather each row's pages into a contiguous view and
    attend keys 0..pos[b] with a masked f32 softmax.  With scale tables
    (int8 pools) the gathered pages dequantize per token and head after
    the gather, in the JAX reference's order (paged_attention.py
    :217-247)."""
    quantized = _scales_pair(k_scales, v_scales)
    b, hq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    p = page_table.shape[1]
    g = hq // hkv
    pt = page_table.long()
    kg, vg = k_pages[pt], v_pages[pt]          # [B, P, Hkv, PS, D]
    if quantized:
        kg = dequantize_vectors(kg, k_scales[pt])
        vg = dequantize_vectors(vg, v_scales[pt])
    # [B, P, Hkv, PS, D] -> [B, Hkv, P*PS, D]
    k = kg.transpose(1, 2).reshape(b, hkv, p * ps, d)
    v = vg.transpose(1, 2).reshape(b, hkv, p * ps, d)
    q4 = q.reshape(b, hkv, g, d).float() * (1.0 / d ** 0.5)
    s = torch.einsum("bhgd,bhsd->bhgs", q4, k.float())
    ids = torch.arange(p * ps, device=q.device)
    keep = ids[None, :] <= pos.long()[:, None]
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    out = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, pos, k_scales=None,
                    v_scales=None):
    """q [B,Hq,D]; k_pages/v_pages [num_pages,Hkv,page_size,D];
    page_table [B,P] int32 (unused entries -> scratch page 0); pos [B]
    int32, valid keys 0..pos[b].  The int8 tier: int8 pools with
    k_scales/v_scales [num_pages,Hkv,page_size] f32.  Returns [B,Hq,D]
    in q's dtype.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (`paged_attention_int8` with scale tables) or
    raise."""
    global launches
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         pos, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    quantized = _scales_pair(k_scales, v_scales)
    b, hq, d = q.shape
    npool, hkv, ps, d2 = k_pages.shape
    if v_pages.shape != k_pages.shape or d2 != d or hq % hkv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"paged_attention: head_dim {d} must be a "
                         "multiple of 8 and <= 256")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or pos.shape != (b,):
        raise ValueError(f"paged_attention: page_table "
                         f"{tuple(page_table.shape)}, pos "
                         f"{tuple(pos.shape)} for batch {b}")
    pool_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in _DTYPES or k_pages.dtype != pool_dtype \
            or v_pages.dtype != pool_dtype:
        raise TypeError(f"paged_attention: dtypes {q.dtype}/"
                        f"{k_pages.dtype}/{v_pages.dtype}; expected "
                        "float32, bfloat16 or float16 q with pools of its "
                        "dtype, "
                        "or int8 pools with scale tables")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and pos must be int32")
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("page_table", page_table), ("pos", pos)]
    if quantized:
        tensors += [("k_scales", k_scales), ("v_scales", v_scales)]
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             f"on {q.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:    # both kernels copy rows 16 bytes a lane
            raise ValueError(f"paged_attention: {name} must start on a "
                             "16-byte boundary")
    out = torch.empty_like(q)
    if quantized:
        return _launch_int8(q, k_pages, v_pages, k_scales, v_scales,
                            page_table, pos, out)
    lib = _build.library("paged_attention", _SIG)
    err = lib.paged_attention(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(page_table), _build.ptr(pos), _build.ptr(out),
        b, hq, hkv, ps, page_table.shape[1], d, 1.0 / d ** 0.5,
        _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    launches += 1
    return out


def _launch_int8(q, k_pages, v_pages, k_scales, v_scales, page_table, pos,
                 out):
    """The int8 tier's launch, after `paged_attention`'s common checks."""
    global int8_launches
    b, hq, d = q.shape
    npool, hkv, ps, _ = k_pages.shape
    if d % 16:
        raise ValueError(f"paged_attention: int8 pools need a head_dim "
                         f"multiple of 16 (one 16-byte load per lane), got "
                         f"{d}")
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if t.dtype != torch.float32 or t.shape != (npool, hkv, ps):
            raise ValueError(f"paged_attention: {name} must be float32 "
                             f"{(npool, hkv, ps)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    lib = _build.library("paged_attention", _INT8_SIG)
    err = lib.paged_attention_int8(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(k_scales), _build.ptr(v_scales), _build.ptr(page_table),
        _build.ptr(pos), _build.ptr(out), b, hq, hkv, ps,
        page_table.shape[1], d, 1.0 / d ** 0.5, _DTYPES[q.dtype],
        _build.stream_ptr(q.device))
    _build.check(err, "paged_attention_int8")
    int8_launches += 1
    return out
