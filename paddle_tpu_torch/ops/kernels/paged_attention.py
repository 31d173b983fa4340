"""Ragged paged-attention decode: CUDA kernel wrapper + plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``
(`_paged_kernel` :68, `paged_attention` :134,
`paged_attention_reference` :217).  The kernel is
``csrc/paged_attention.cu``.  The int8 pool tier (scale tables) is not
ported yet (ROADMAP Queue B).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:68 (_paged_kernel)"

launches = 0

_SIG = {"paged_attention": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _no_scales(k_scales, v_scales):
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8 KV pools with scale tables are not ported yet "
            "(ROADMAP Queue B: int8-KV tier)")


def paged_attention_reference(q, k_pages, v_pages, page_table, pos,
                              k_scales=None, v_scales=None):
    """Plain version: gather each row's pages into a contiguous view and
    attend keys 0..pos[b] with a masked f32 softmax."""
    _no_scales(k_scales, v_scales)
    b, hq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    p = page_table.shape[1]
    g = hq // hkv
    pt = page_table.long()
    # [B, P, Hkv, PS, D] -> [B, Hkv, P*PS, D]
    k = k_pages[pt].transpose(1, 2).reshape(b, hkv, p * ps, d)
    v = v_pages[pt].transpose(1, 2).reshape(b, hkv, p * ps, d)
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
    int32, valid keys 0..pos[b].  Returns [B,Hq,D].  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    global launches
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         pos, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _no_scales(k_scales, v_scales)
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
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: dtypes {q.dtype}/"
                        f"{k_pages.dtype}/{v_pages.dtype}; expected "
                        "float32 or bfloat16, all alike")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and pos must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("pos", pos)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             f"on {q.device}")
    out = torch.empty_like(q)
    lib = _build.library("paged_attention", _SIG)
    err = lib.paged_attention(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(page_table), _build.ptr(pos), _build.ptr(out),
        b, hq, hkv, ps, page_table.shape[1], d, 1.0 / d ** 0.5,
        _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    launches += 1
    return out
