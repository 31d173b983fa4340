"""Dense KV-cache decode attention: CUDA kernel wrapper + plain version.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``
(`_decode_kernel` :42, `decode_attention` :82).  The kernel is
``csrc/decode_attention.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
SOURCE = "paddle_tpu_torch/csrc/decode_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/decode_attention.py:42 (_decode_kernel)"

launches = 0

_SIG = {"decode_attention": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def decode_attention_reference(q, kcache, vcache, pos, start=None):
    """Plain version: masked f32 softmax over cache keys start..pos."""
    b, hq, d = q.shape
    hkv, s = kcache.shape[1], kcache.shape[2]
    g = hq // hkv
    q4 = q.reshape(b, hkv, g, d).float() * (1.0 / d ** 0.5)
    sc = torch.einsum("bhgd,bhsd->bhgs", q4, kcache.float())
    ids = torch.arange(s, device=q.device)[None, :]
    keep = ids <= pos.long()[:, None]
    if start is not None:
        keep = keep & (ids >= start.long()[:, None])
    sc = torch.where(keep[:, None, None, :], sc, NEG_INF)
    out = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(sc, dim=-1),
                       vcache.float())
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention(q, kcache, vcache, pos, start=None):
    """q [B,Hq,D]; kcache/vcache [B,Hkv,S,D] (holding the current token
    at pos[b]); pos [B] int32; start optional [B] int32, the first valid
    cache index per row (left-padded prompts).  Returns [B,Hq,D].  CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_reference(q, kcache, vcache, pos, start)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, hq, d = q.shape
    b2, hkv, s, d2 = kcache.shape
    if vcache.shape != kcache.shape or b2 != b or d2 != d or hq % hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(kcache.shape)}/{tuple(vcache.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"decode_attention: head_dim {d} must be a "
                         "multiple of 8 and <= 256")
    if q.dtype not in _DTYPES or kcache.dtype != q.dtype \
            or vcache.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/"
                        f"{kcache.dtype}/{vcache.dtype}; expected float32, "
                        "bfloat16 or float16, all alike")
    idx = [("pos", pos)] + ([("start", start)] if start is not None else [])
    for name, t in idx:
        if t.dtype != torch.int32 or t.shape != (b,):
            raise TypeError(f"decode_attention: {name} must be int32 [{b}]")
    for name, t in [("q", q), ("kcache", kcache), ("vcache", vcache)] + idx:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"on {q.device}")
    for name, t in (("kcache", kcache), ("vcache", vcache)):
        if t.data_ptr() % 16:    # the kernel copies rows 16 bytes a lane
            raise ValueError(f"decode_attention: {name} must start on a "
                             "16-byte boundary")
    out = torch.empty_like(q)
    lib = _build.library("decode_attention", _SIG)
    err = lib.decode_attention(
        _build.ptr(q), _build.ptr(kcache), _build.ptr(vcache),
        _build.ptr(pos), _build.ptr(start) if start is not None else None,
        _build.ptr(out), b, hq, hkv, s, d, 1.0 / d ** 0.5,
        _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "decode_attention")
    launches += 1
    return out
