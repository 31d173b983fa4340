"""Fused (bias + residual +) RMS / LayerNorm: CUDA kernel wrapper, plain
version, and the `FusedNorm` autograd function over them.

Counterpart of ``paddle_tpu/ops/pallas/fused_norm.py``: the forward
`_norm_kernel` :58 launched by `_pallas_norm_fwd` :93 (kernel
``csrc/fused_norm.cu``), and the jnp backward `_norm_bwd_math` :139 /
`core_bwd` :199, which stays plain PyTorch here as it is jnp there.  The
JAX gate `fused_norm_available` (:34: ``d % 128``, ``d <= 16384``) is a
TPU layout rule with no counterpart: the kernel takes any d >= 1 and any
row count.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _op

SOURCE = "paddle_tpu_torch/csrc/fused_norm.cu"
REPLACES = ("paddle_tpu/ops/pallas/fused_norm.py:58 (_norm_kernel, via "
            "_pallas_norm_fwd :93)")

launches = 0

_SIG = {"fused_norm": [ctypes.c_void_p] * 7
        + [ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KINDS = ("rms", "ln")
# the scalar kernel keeps a row of z as f32 in shared memory (227 KB a
# block); the vector kernel takes the rows it can hold in registers
MAX_D = 227 * 1024 // 4


def _sum(x, bias, residual):
    """z = x (+ bias) (+ residual) in x's dtype, each add rounded (the
    JAX kernel's order, :70-74)."""
    z = x
    if bias is not None:
        z = z + bias
    if residual is not None:
        z = z + residual
    return z


def _stats(z32, kind, eps):
    """(centred or raw z in f32, 1 / sqrt(second moment + eps))."""
    if kind == "rms":
        ms = (z32 * z32).mean(dim=-1, keepdim=True)
        return z32, torch.rsqrt(ms + eps)
    xc = z32 - z32.mean(dim=-1, keepdim=True)
    return xc, torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)


def fused_norm_reference(x, w=None, b=None, bias=None, residual=None,
                         eps=1e-6, kind="rms"):
    """Plain version: (y, z) with z None unless bias or residual is given.
    Statistics of the rounded z in f32, LayerNorm's variance centred;
    w and b applied in f32, y rounded once to x's dtype."""
    z = _sum(x, bias, residual)
    xc, inv = _stats(z.float(), kind, eps)
    y = xc * inv
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    want_z = bias is not None or residual is not None
    return y.to(x.dtype), (z if want_z else None)


def _check(x, w, b, bias, residual, kind):
    """The kernel's refusals, in one pass over the operands (this runs on
    every call, so it reads each attribute once).  Returns (d, the dtype
    code of x, that of w / b)."""
    dev = x.device
    if kind not in _KINDS:
        raise ValueError(f"fused_norm: kind {kind!r} not in {_KINDS}")
    xdt = x.dtype
    code = _DTYPES.get(xdt)
    if code is None:
        raise TypeError(f"fused_norm: x dtype {xdt}; expected float32, "
                        "bfloat16 or float16")
    shape = x.shape
    d = shape[-1] if shape else 0
    if not 1 <= d <= MAX_D:
        raise ValueError(f"fused_norm: last axis {d} must be in "
                         f"1..{MAX_D}")
    wdt = {t.dtype for t in (w, b) if t is not None}
    if len(wdt) > 1 or not wdt <= {torch.float32, xdt}:
        raise TypeError(f"fused_norm: w / b dtypes {sorted(map(str, wdt))};"
                        f" expected one of float32 or {xdt}")
    for name, t in (("w", w), ("b", b), ("bias", bias),
                    ("residual", residual)):
        if t is None:
            continue
        want = shape if name == "residual" else (d,)
        if t.shape != want:
            raise ValueError(f"fused_norm: {name} of shape "
                             f"{tuple(t.shape)}, expected {tuple(want)}")
        if name in ("bias", "residual") and t.dtype != xdt:
            raise TypeError(f"fused_norm: {name} dtype {t.dtype} differs "
                            f"from x's {xdt}")
    for name, t in (("x", x), ("w", w), ("b", b), ("bias", bias),
                    ("residual", residual)):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"fused_norm: {name} must be contiguous on "
                             f"{dev}")
    return d, code, (_DTYPES[wdt.pop()] if wdt else code)


def fused_norm(x, w=None, b=None, bias=None, residual=None, eps=1e-6,
               kind="rms"):
    """x [..., d]; w, b, bias [d]; residual like x.  Returns (y, z): y
    the norm of z = x + bias + residual over the last axis, in x's
    dtype; z None unless bias or residual is given.  `kind` "rms" or
    "ln".  The op ``paddle_tpu_torch::fused_norm``: CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    _op.check_device("fused_norm", x)
    outs = _fused_norm_op(x, w, b, bias, residual, float(eps), kind)
    return outs[0], (outs[1] if len(outs) > 1 else None)


def _fused_norm_cpu(x, w, b, bias, residual, eps, kind):
    """The CPU implementation of ``paddle_tpu_torch::fused_norm``."""
    y, z = fused_norm_reference(x, w, b, bias, residual, eps, kind)
    return [y] if z is None else [y, z]


def _fused_norm_cuda(x, w, b, bias, residual, eps, kind):
    """The CUDA implementation of ``paddle_tpu_torch::fused_norm``."""
    global launches
    d, code, wcode = _check(x, w, b, bias, residual, kind)
    y = torch.empty_like(x)
    want_z = bias is not None or residual is not None
    z = torch.empty_like(x) if want_z else None
    lib = _build.library("fused_norm", _SIG)
    opt = [None if t is None else _build.ptr(t)
           for t in (w, b, bias, residual)]
    err = lib.fused_norm(_build.ptr(x), *opt, _build.ptr(y),
                         None if z is None else _build.ptr(z),
                         x.numel() // d, d, float(eps), int(kind == "rms"),
                         code, wcode, _build.stream_ptr(x.device))
    _build.check(err, "fused_norm")
    launches += 1
    return [y] if z is None else [y, z]


def _fused_norm_fake(x, w, b, bias, residual, eps, kind):
    want_z = bias is not None or residual is not None
    return [torch.empty_like(x) for _ in range(2 if want_z else 1)]


_fused_norm_op = _op.define(
    "fused_norm", "(Tensor x, Tensor? w, Tensor? b, Tensor? bias, "
    "Tensor? residual, float eps, str kind) -> Tensor[]", _fused_norm_cpu,
    _fused_norm_cuda, _fused_norm_fake)


class FusedNorm(torch.autograd.Function):
    """``fused_norm`` differentiated as the JAX custom VJP
    (`fused_norm.py:185-216`): the forward is the kernel (plain on the
    CPU); the backward recomputes the statistics from the saved z (x
    when neither bias nor residual is given) in plain PyTorch, in
    `_norm_bwd_math`'s order.  dz is rounded to z's dtype before z's own
    cotangent is added; db is cast to z's dtype, dw to w's; dbias is the
    f32 row sum of dz, dres is dz.  Returns y, or (y, z) when bias or
    residual is given."""

    @staticmethod
    def forward(ctx, x, w, b, bias, residual, eps, kind):
        y, z = fused_norm(x, w, b, bias, residual, eps=eps, kind=kind)
        ctx.want_z = z is not None
        ctx.eps, ctx.kind = eps, kind
        ctx.has = tuple(t is not None for t in (w, b, bias, residual))
        ctx.save_for_backward(z if ctx.want_z else x, w)
        return (y, z) if ctx.want_z else y

    @staticmethod
    def backward(ctx, gy, gz=None):
        z, w = ctx.saved_tensors
        xc, inv = _stats(z.float(), ctx.kind, ctx.eps)
        xhat = xc * inv
        g32 = gy.float()
        gw = g32 * w.float() if w is not None else g32
        proj = (gw * xhat).mean(dim=-1, keepdim=True)
        if ctx.kind == "rms":
            dz = inv * (gw - xhat * proj)
        else:
            dz = inv * (gw - gw.mean(dim=-1, keepdim=True) - xhat * proj)
        dz = dz.to(z.dtype)
        if ctx.want_z and gz is not None:
            dz = dz + gz.to(dz.dtype)
        rows = tuple(range(z.dim() - 1))
        has_w, has_b, has_bias, has_res = ctx.has
        dw = (g32 * xhat).sum(dim=rows).to(w.dtype) if has_w else None
        db = g32.sum(dim=rows).to(z.dtype) if has_b else None
        dbias = dz.float().sum(dim=rows).to(z.dtype) if has_bias else None
        dres = dz if has_res else None
        return dz, dw, db, dbias, dres, None, None
