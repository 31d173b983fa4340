"""Rotary position embedding: CUDA kernel wrapper + plain version, and
the `RoPE` autograd function over them.

Counterpart of ``paddle_tpu/ops/pallas/rope.py`` (`_rope_kernel` :40,
`_rope_call` :56, the custom VJP of `rope_pallas` :80-95).  The kernel
is ``csrc/rope.cu``; one wrapper launches it for the forward and, with
``adjoint=True``, for the backward, each direction on its own launch
counter.  Given a second tensor `k` under the same phases (the keys
beside the queries), one launch rotates both and counts once.  The JAX
package's ``(h * d) % 128`` gate (:35) is a TPU layout rule: the kernel
takes any even head_dim and any head count.  The
interleaved style, which the JAX package computes in jnp, runs through
the same kernel, so no CUDA tensor takes a plain rotation.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _op

SOURCE = "paddle_tpu_torch/csrc/rope.cu"
REPLACES = ("paddle_tpu/ops/pallas/rope.py:40 (_rope_kernel, via "
            "_rope_call :56, forward of rope_pallas :81)")
BWD_REPLACES = ("paddle_tpu/ops/pallas/rope.py:90 (_rope_bwd: _rope_call "
                ":56 with the adjoint rotation)")

# kernel launches since the last reset (the plain paths never count)
launches = 0        # rope, forward
bwd_launches = 0    # rope, adjoint

_SIG = {"rope": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_int64] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 1024


def rope_reference(x, cos, sin, adjoint=False, interleaved=False):
    """Plain version, the kernel's arithmetic: f32 math, one rounding to
    x's dtype.  x [B,S,H,D]; cos/sin broadcastable to it ([B|1,S,1,D]).
    Neox: out = x*cos + rot(x)*sin with rot(x) = concat(-x2, x1), and
    the adjoint concat(x2, -x1) times the same-index sin (the JAX
    formula, exact when both halves of sin are equal).  Interleaved:
    the pairs (2i, 2i+1), and the adjoint is the exact VJP."""
    xf, c, s = x.float(), cos.float(), sin.float()
    if interleaved:
        x1, x2 = xf[..., ::2], xf[..., 1::2]
        if adjoint:       # g*cos + rot^T(g*sin)
            rot_s = torch.stack([x2 * s[..., 1::2], -x1 * s[..., ::2]], -1)
            out = xf * c + rot_s.reshape(xf.shape)
        else:
            out = xf * c + torch.stack([-x2, x1], -1).reshape(xf.shape) * s
    else:
        x1, x2 = xf.chunk(2, dim=-1)
        rot = torch.cat([x2, -x1] if adjoint else [-x2, x1], dim=-1)
        out = xf * c + rot * s
    return out.to(x.dtype)


def _phases(name, p, b, s, d, x):
    """[B|1, S, 1, D] phases in x's dtype -> (contiguous [B|1, S, D],
    batch stride: 0 when broadcast over the batch)."""
    if p.dim() != 4 or p.shape[0] not in (1, b) or p.shape[1:] != (s, 1, d):
        raise ValueError(f"rope: {name} {tuple(p.shape)} is not "
                         f"[{b} or 1, {s}, 1, {d}]")
    if p.dtype != x.dtype or p.device != x.device:
        raise TypeError(f"rope: {name} must be {x.dtype} on {x.device}, "
                        f"got {p.dtype} on {p.device}")
    p = p.reshape(p.shape[0], s, d).contiguous()
    return p, (s * d if p.shape[0] > 1 else 0)


def _unit_last(name, t, b, s, d, x):
    """t as a [B, S, H, D] tensor of x's batch, tokens, head_dim, dtype and
    device, with a unit last stride (copied when it has none)."""
    if t.dim() != 4 or t.shape[0] != b or t.shape[1] != s \
            or t.shape[3] != d:
        raise ValueError(f"rope: {name} {tuple(t.shape)} is not "
                         f"[{b}, {s}, H, {d}]")
    if t.dtype != x.dtype or t.device != x.device:
        raise TypeError(f"rope: {name} must be {x.dtype} on {x.device}, "
                        f"got {t.dtype} on {t.device}")
    if t.numel() == 0:
        raise ValueError(f"rope: empty input {name} {tuple(t.shape)}")
    return t if t.stride(3) == 1 else t.contiguous()


def rope(x, cos, sin, adjoint=False, interleaved=False, k=None):
    """x [B,S,H,D] (any batch / token / head strides, unit last stride);
    cos/sin [B|1,S,1,D] in x's dtype.  Returns the rotation (or, with
    `adjoint`, its adjoint) as a contiguous [B,S,H,D] tensor; with `k`
    ([B,S,Hk,D], the same phases) the pair (x's, k's), from one launch.
    The op ``paddle_tpu_torch::rope``: CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    _op.check_device("rope", x)
    outs = _rope_op(x, cos, sin, bool(adjoint), bool(interleaved), k)
    return outs[0] if k is None else tuple(outs)


def _rope_cpu(x, cos, sin, adjoint, interleaved, k):
    """The CPU implementation of ``paddle_tpu_torch::rope``: the plain
    version of x (and of k)."""
    return [rope_reference(t, cos, sin, adjoint, interleaved)
            for t in ((x,) if k is None else (x, k))]


def _rope_cuda(x, cos, sin, adjoint, interleaved, k):
    """The CUDA implementation of ``paddle_tpu_torch::rope``: one launch
    for x (and k), counted by direction."""
    global launches, bwd_launches
    if x.dim() != 4:
        raise ValueError(f"rope: x must be [B, S, H, D], got "
                         f"{tuple(x.shape)}")
    b, s, _, d = x.shape
    if d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"rope: head_dim {d} must be even and <= "
                         f"{MAX_HEAD_DIM}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rope: dtype {x.dtype}; expected float32, "
                        "bfloat16 or float16")
    xs = [_unit_last("x", x, b, s, d, x)]
    if k is not None:
        xs.append(_unit_last("k", k, b, s, d, x))
    cos, spb = _phases("cos", cos, b, s, d, x)
    sin, _ = _phases("sin", sin, b, s, d, x)
    strides = [t.stride(i) for t in xs for i in range(3)]
    vec = 16 // x.element_size()
    if interleaved or (d // 2) % vec or any(t.data_ptr() % 16 for t in xs) \
            or any(st % vec for st in strides):
        vec = 1
    outs = [torch.empty(t.shape, dtype=x.dtype, device=x.device)
            for t in xs]
    # without k the second tensor's slots are null, with no heads
    pad = 2 - len(xs)
    ins = [_build.ptr(t) for t in xs] + [None] * pad
    ptrs = [_build.ptr(t) for t in outs] + [None] * pad
    heads = [t.shape[2] for t in xs] + [0] * pad
    lib = _build.library("rope", _SIG)
    err = lib.rope(
        *ins, _build.ptr(cos), _build.ptr(sin), *ptrs, b, s, *heads, d,
        *strides, *[0] * (3 * pad), spb, int(bool(adjoint)),
        int(bool(interleaved)), vec, _DTYPES[x.dtype],
        _build.stream_ptr(x.device))
    _build.check(err, "rope")
    if adjoint:
        bwd_launches += 1
    else:
        launches += 1
    return outs


def _rope_fake(x, cos, sin, adjoint, interleaved, k):
    return [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in ((x,) if k is None else (x, k))]


_rope_op = _op.define(
    "rope", "(Tensor x, Tensor cos, Tensor sin, bool adjoint, "
    "bool interleaved, Tensor? k) -> Tensor[]", _rope_cpu, _rope_cuda,
    _rope_fake)


class RoPE(torch.autograd.Function):
    """out = rope(x, cos, sin) through the kernel, differentiated by the
    same kernel's adjoint (`rope_pallas`'s custom VJP, :86-95).  With
    `k` (the keys beside the queries x) both rotate in one launch each
    way and the outputs are (x's, k's).  The phases get no gradient."""

    @staticmethod
    def forward(ctx, x, cos, sin, interleaved=False, k=None):
        ctx.save_for_backward(cos, sin)
        ctx.interleaved = interleaved
        ctx.paired = k is not None
        return rope(x, cos, sin, interleaved=interleaved, k=k)

    @staticmethod
    def backward(ctx, g, gk=None):
        cos, sin = ctx.saved_tensors
        out = rope(g, cos, sin, adjoint=True, interleaved=ctx.interleaved,
                   k=gk)
        dx, dk = out if ctx.paired else (out, None)
        return dx, None, None, None, dk
