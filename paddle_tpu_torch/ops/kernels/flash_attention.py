"""Flash-attention forward: CUDA kernel wrapper + plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``'s forward
(`_online_softmax` :149, `_fwd_kernel` :241, `_fwd_kernel_bias` :256,
`_ref_attention` :1655).  The kernel is ``csrc/flash_fwd.cu``.  The JAX
package's Mosaic workarounds (the `_biased_flash_ok` ``sk % 128`` gate,
the flat/kv/mh layout tiers, block autotuning) have no counterpart: one
kernel takes every Sq/Sk, GQA and broadcast bias in the native
``[B, S, H, D]`` layout.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
SOURCE = "paddle_tpu_torch/csrc/flash_fwd.cu"
REPLACES = ("paddle_tpu/ops/pallas/flash_attention.py:241 (_fwd_kernel, "
            "via _fwd_t :291/_fwd_mh :384/_fwd_kv :913/_fwd_flat :1239) "
            "and :256 (_fwd_kernel_bias, via _fwd_tb :1503)")

# kernel launches since the last reset (the plain path never counts)
launches = 0

_SIG = {"flash_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _as_bias(bias, b, hq, sq, sk):
    """f32 additive bias viewable as [B, Hq, Sq, Sk] (a boolean mask
    becomes 0 / NEG_INF, as flash_attention.py:1815 does)."""
    if bias is None:
        return None
    if bias.dtype == torch.bool:
        bias = torch.where(bias, 0.0, NEG_INF)
    bias = bias.to(torch.float32)
    while bias.dim() < 4:
        bias = bias.unsqueeze(0)
    mb, mh, mq, mk = bias.shape
    if mb not in (1, b) or mh not in (1, hq) or mq not in (1, sq) \
            or mk != sk:
        raise ValueError(f"bias of shape {tuple(bias.shape)} does not "
                         f"broadcast to [{b}, {hq}, {sq}, {sk}]")
    return bias.expand(b, hq, sq, sk)


def flash_fwd_reference(q, k, v, bias=None, causal=False):
    """Plain version: (out [B,Sq,Hq,D] in q's dtype, lse [B,Hq,Sq] f32).
    Scores and softmax in f32; scale, then bias, then the causal mask
    (bottom-right aligned), in the kernel's order."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    bias = _as_bias(bias, b, hq, sq, sk)
    if bias is not None:
        s = s + bias
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(keep, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                       v.float())
    return out.to(q.dtype), lse


def flash_fwd(q, k, v, bias=None, causal=False):
    """q [B,Sq,Hq,D]; k/v [B,Sk,Hkv,D] (Hq % Hkv == 0); bias optional,
    broadcastable to [B,Hq,Sq,Sk] (additive f32, or bool keep-mask).
    Returns (out [B,Sq,Hq,D], lse [B,Hq,Sq] f32).  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    global launches
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"flash_fwd: head_dim {d} must be a multiple of "
                         "8 and <= 256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                        "; expected float32 or bfloat16, all alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous on "
                             f"{q.device}")
    if sq == 0 or sk == 0:
        raise ValueError("flash_fwd: empty sequence")
    bias = _as_bias(bias, b, hq, sq, sk)
    strides = (0, 0, 0)
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("flash_fwd: bias on another device")
        if bias.stride(3) != 1:
            bias = bias.contiguous()
        # broadcast batch / head / query dims carry stride 0
        strides = tuple(bias.stride(i) for i in range(3))
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, device=q.device, dtype=torch.float32)
    lib = _build.library("flash_fwd", _SIG)
    err = lib.flash_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(bias) if bias is not None else None,
        _build.ptr(out), _build.ptr(lse), b, sq, sk, hq, hkv, d,
        *strides, int(bool(causal)), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
        _build.stream_ptr(q.device))
    _build.check(err, "flash_fwd")
    launches += 1
    return out, lse
