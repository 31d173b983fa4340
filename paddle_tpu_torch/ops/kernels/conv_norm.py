"""Fused conv -> folded batch-norm affine -> activation: CUDA kernel
wrapper + plain version, and the `ConvBNAct` autograd function.

Counterpart of ``paddle_tpu/ops/pallas/conv_norm.py`` (`_conv_kernel`
:82, launched by `_conv_pallas` :255, under the custom VJP
`_conv_pallas_vjp` :285-315).  The kernel is ``csrc/conv_bn_act.cu``:
an implicit-GEMM direct conv for dense weights (padding as bounds math,
no padded copy of x; bf16 and f16 on the tensor cores, f32 on CUDA
cores) and a per-channel loop for depthwise weights (``cin_g == 1 and
cout == cin``), both with the epilogue ``act(acc * scale + shift)`` cast
to x's dtype.  The JAX package's row
band, VMEM gate and autotune (`_pick_rows`, `conv_bn_act_available`)
are TPU tiling and have no counterpart: the kernel takes any dense or
depthwise shape.  As in JAX there is no backward kernel: `ConvBNAct`
runs the kernel forward and differentiates the plain version backward.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _op

SOURCE = "paddle_tpu_torch/csrc/conv_bn_act.cu"
REPLACES = ("paddle_tpu/ops/pallas/conv_norm.py:82 (_conv_kernel, via "
            "_conv_pallas :255)")

# kernel launches since the last reset (the plain paths never count)
launches = 0

_ACTS = {None: 0, "relu": 1, "relu6": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIG = {"conv_bn_act": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16
        + [ctypes.c_void_p]}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(int(i) for i in v)


def _out_dim(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _apply_act(y, act):
    if act == "relu":
        return torch.clamp(y, min=0)
    if act == "relu6":
        return torch.clamp(y, 0, 6)
    return y


def conv_bn_act_reference(x, w, scale, shift, stride=1, padding=0,
                          act="relu", depthwise=False):
    """Plain version, the JAX `conv_bn_act_ref` (:63): the conv of x and
    w widened to f32, then ``* scale + shift`` in f32, the activation,
    and one rounding to x's dtype.  x [B, Cin, H, W]; w [Cout, Cin_g,
    kh, kw]; scale / shift [Cout]."""
    out = F.conv2d(x.float(), w.float(), None, stride, padding, 1,
                   x.shape[1] if depthwise else 1)
    out = out * scale.float().reshape(1, -1, 1, 1) \
        + shift.float().reshape(1, -1, 1, 1)
    return _apply_act(out, act).to(x.dtype)


def is_depthwise(x, w):
    return w.shape[1] == 1 and w.shape[0] == x.shape[1]


def conv_bn_act(x, w, scale, shift, stride=1, padding=0, act="relu"):
    """act(conv(x, w) * scale + shift) in x's dtype, NCHW.  x [B, Cin,
    H, W]; w [Cout, Cin, kh, kw] (dense) or [Cin, 1, kh, kw]
    (depthwise), in x's dtype; scale / shift [Cout] f32 (the folded
    norm); int or pair stride and symmetric padding; act 'relu',
    'relu6' or None.  The op ``paddle_tpu_torch::conv_bn_act``: CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if act not in _ACTS:
        raise ValueError(f"conv_bn_act: act {act!r}; expected 'relu', "
                         "'relu6' or None")
    _op.check_device("conv_bn_act", x)
    return _conv_bn_act_op(x, w, scale, shift, list(_pair(stride)),
                           list(_pair(padding)), act)


def _conv_bn_act_cpu(x, w, scale, shift, stride, padding, act):
    """The CPU implementation of ``paddle_tpu_torch::conv_bn_act``."""
    return conv_bn_act_reference(x, w, scale, shift, stride, padding, act,
                                 is_depthwise(x, w))


def _conv_bn_act_cuda(x, w, scale, shift, stride, padding, act):
    """The CUDA implementation of ``paddle_tpu_torch::conv_bn_act``."""
    global launches
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv_bn_act: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be 4-D (NCHW, OIHW)")
    b, cin, h, wd = x.shape
    cout, cin_g, kh, kw = w.shape
    depthwise = is_depthwise(x, w)
    if not depthwise and cin_g != cin:
        raise ValueError(f"conv_bn_act: w {tuple(w.shape)} is neither "
                         f"dense nor depthwise for {cin} input channels")
    if w.device != x.device:
        raise ValueError(f"conv_bn_act: w on device {w.device}, x on "
                         f"{x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv_bn_act: x {x.dtype} and w {w.dtype}; "
                        "expected both float32, bfloat16 or float16")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (cout,) or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"conv_bn_act: {name} must be float32 "
                             f"[{cout}] on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if min(sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"conv_bn_act: stride {stride}, padding "
                         f"{padding}")
    ho, wo = _out_dim(h, kh, sh, ph), _out_dim(wd, kw, sw, pw)
    if min(b, cin, ho, wo) < 1:
        raise ValueError(f"conv_bn_act: empty output for x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if max(x.numel(), w.numel(), b * cout * ho * wo) >= 2 ** 31:
        raise ValueError("conv_bn_act: a tensor has 2**31 or more elements")
    x, w = x.contiguous(), w.contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    out = torch.empty(b, cout, ho, wo, dtype=x.dtype, device=x.device)
    lib = _build.library("conv_bn_act", _SIG)
    err = lib.conv_bn_act(
        _build.ptr(x), _build.ptr(w), _build.ptr(scale),
        _build.ptr(shift), _build.ptr(out), b, cin, h, wd,
        cout, kh, kw, sh, sw, ph, pw, ho, wo, _ACTS[act], int(depthwise),
        _DTYPES[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, "conv_bn_act")
    launches += 1
    return out


def _conv_bn_act_fake(x, w, scale, shift, stride, padding, act):
    ho = _out_dim(x.shape[2], w.shape[2], stride[0], padding[0])
    wo = _out_dim(x.shape[3], w.shape[3], stride[1], padding[1])
    return x.new_empty((x.shape[0], w.shape[0], ho, wo))


_conv_bn_act_op = _op.define(
    "conv_bn_act", "(Tensor x, Tensor w, Tensor scale, Tensor shift, "
    "int[] stride, int[] padding, str? act) -> Tensor", _conv_bn_act_cpu,
    _conv_bn_act_cuda, _conv_bn_act_fake)


class ConvBNAct(torch.autograd.Function):
    """out = conv_bn_act(x, w, scale, shift) through the kernel; the
    backward differentiates the plain version (`_conv_pallas_vjp_bwd`
    :304-315: there is no backward kernel in the JAX package either)."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, stride, padding, act):
        ctx.save_for_backward(x, w, scale, shift)
        ctx.cfg = (stride, padding, act)
        return conv_bn_act(x, w, scale, shift, stride, padding, act)

    @staticmethod
    def backward(ctx, g):
        stride, padding, act = ctx.cfg
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = conv_bn_act_reference(*ins, stride, padding, act,
                                        is_depthwise(ins[0], ins[1]))
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(got) if n else None for n in need), None, None,
                None)
