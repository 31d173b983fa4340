"""Flash attention: CUDA kernel wrappers + plain PyTorch versions, forward
and backward, and the `FlashAttention` autograd function over them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: the forward
(`_online_softmax` :149, `_fwd_kernel` :241, `_fwd_kernel_bias` :256,
`_ref_attention` :1655; kernel ``csrc/flash_fwd.cu``) and the backward
(`_dq_loop` :421, `_dkv_loop` :536 under `_bwd_flat` :1329, `_bwd_t`
:720, `_bwd_mh` :672, `_bwd_kv` :1020 and `_bwd_tb` :1541; kernel
``csrc/flash_bwd.cu``).  The JAX package's Mosaic workarounds (the
`_biased_flash_ok` ``sk % 128`` and MHA-only gate, the flat/mh layout
tiers, block autotuning) have no counterpart: one kernel per direction
takes every Sq/Sk, GQA and broadcast bias in the native ``[B, S, H, D]``
layout.  The `kv` layout tier (``FLAGS_flash_layout=kv``) is ported as
`FlashAttentionKV`, the counterpart of `_flash_core_kv` (:1070): the same
kernels in their head-major mode (``head_major=True``: Q, O, dO and dQ
are ``[B, H, S, D]``), with Q and dO moved there and O and dQ back by the
relayout kernels (`ops/kernels/relayout.py`).
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build, _op
from .relayout import from_head_major, to_head_major

NEG_INF = -1e30
SOURCE = "paddle_tpu_torch/csrc/flash_fwd.cu"
REPLACES = ("paddle_tpu/ops/pallas/flash_attention.py:241 (_fwd_kernel, "
            "via _fwd_t :291/_fwd_mh :384/_fwd_kv :913/_fwd_flat :1239) "
            "and :256 (_fwd_kernel_bias, via _fwd_tb :1503)")
BWD_SOURCE = "paddle_tpu_torch/csrc/flash_bwd.cu"
BWD_REPLACES = ("paddle_tpu/ops/pallas/flash_attention.py:1329 (_bwd_flat; "
                "the same math in _bwd_t :720/_bwd_mh :672/_bwd_kv :1020) "
                "and :1541 (_bwd_tb)")

# kernel launches since the last reset (the plain paths never count)
launches = 0        # flash_fwd
bwd_launches = 0    # flash_bwd

_SIG = {"flash_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_void_p],
        "flash_fwd_hm": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
_BWD_SIG = {"flash_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
            + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p],
            "flash_bwd_hm": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the layout tiers of the JAX package's FLAGS_flash_layout; only "kv"
# runs another path here
DEFAULT_LAYOUT = "auto"


def layout_flag() -> str:
    """FLAGS_flash_layout, read at call time (default "auto"), as JAX's
    `_layout_flag` (flash_attention.py:1485-1488)."""
    return os.environ.get("FLAGS_flash_layout", DEFAULT_LAYOUT)


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


def _scores(q, k, bias, causal):
    """f32 scores [B, Hq, Sq, Sk] in the kernels' order: scale, then
    bias, then the causal mask (bottom-right aligned); GQA kv heads
    expanded.  Returns (scores, k expanded to Hq heads)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    k = k.float()
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * (1.0 / math.sqrt(d))
    bias = _as_bias(bias, b, hq, sq, sk)
    if bias is not None:
        s = s + bias
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(keep, s, NEG_INF)
    return s, k


def flash_fwd_reference(q, k, v, bias=None, causal=False, head_major=False):
    """Plain version: (out [B,Sq,Hq,D] in q's dtype, lse [B,Hq,Sq] f32).
    Scores and softmax in f32.  head_major: q and out are [B,Hq,Sq,D]
    (the native arithmetic on the relaid q, so bit for bit the native
    result)."""
    if head_major:
        out, lse = flash_fwd_reference(q.transpose(1, 2).contiguous(), k, v,
                                       bias, causal)
        return out.transpose(1, 2).contiguous(), lse
    hq, hkv = q.shape[2], k.shape[2]
    s, _ = _scores(q, k, bias, causal)
    v = v.float()
    if hq != hkv:
        v = v.repeat_interleave(hq // hkv, dim=2)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return out.to(q.dtype), lse


def _bias_shape4(bias):
    """The bias's shape as [mb, mh, mq, Sk] (leading 1s added)."""
    return (1,) * (4 - bias.dim()) + tuple(bias.shape)


def _reduce_to_bias(g, bias):
    """g [B, Hq, Sq, Sk] f32 summed over the bias's broadcast axes, in
    the bias's shape and dtype."""
    shape4 = _bias_shape4(bias)
    axes = [i for i in range(3) if shape4[i] == 1 and g.shape[i] != 1]
    if axes:
        g = g.sum(dim=axes, keepdim=True)
    return g.reshape(bias.shape).to(bias.dtype)


def flash_bwd_reference(q, k, v, out, lse, dout, bias=None, causal=False,
                        head_major=False, bias_grad=False):
    """Plain version of the backward: (dq, dk, dv) in the dtypes of q, k,
    v, everything in f32 between.  The math of `_dq_loop` / `_dkv_loop`:
    p = exp(scores - lse) from the saved LSE, delta = rowsum(dO * O),
    ds = p * (dO.v - delta) * scale; dK / dV summed over each GQA group.
    With `bias_grad` also dBias = p * (dO.v - delta) (the gradient of the
    scores after the scale, where the bias is added), summed over the
    bias's broadcast axes, in its shape and dtype, as a fourth output.
    head_major: q, out, dout and dq are [B,Hq,Sq,D]; k, v, dk, dv stay
    native."""
    if head_major:
        q, out, dout = (t.transpose(1, 2).contiguous()
                        for t in (q, out, dout))
        dq, dk, dv = flash_bwd_reference(q, k, v, out, lse, dout, bias,
                                         causal)
        return dq.transpose(1, 2).contiguous(), dk, dv
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    s, kf = _scores(q, k, bias, causal)
    vf = v.float()
    if hq != hkv:
        vf = vf.repeat_interleave(hq // hkv, dim=2)
    p = torch.exp(s - lse[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)          # [B,Hq,Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    dx = p * (dp - delta[..., None])
    ds = dx * (1.0 / math.sqrt(d))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    if hq != hkv:
        # query head h serves kv head h // rep: consecutive groups
        dk = dk.reshape(b, sk, hkv, hq // hkv, d).sum(3)
        dv = dv.reshape(b, sk, hkv, hq // hkv, d).sum(3)
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if bias_grad:
        return grads + (_reduce_to_bias(dx, bias),)
    return grads


def _check_qkv(fn, q, k, v, head_major=False):
    """What both kernels take: q [B,Sq,Hq,D] ([B,Hq,Sq,D] head-major),
    k/v [B,Sk,Hkv,D] with Hq % Hkv == 0, D % 8 == 0 and D <= 256, f32,
    bf16 or f16 alike (every mode), contiguous, on q's CUDA device.  Returns (B, Sq, Sk, Hq, Hkv,
    D)."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if head_major:
        b, hq, sq, d = q.shape
    else:
        b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"{fn}: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"{fn}: head_dim {d} must be a multiple of 8 "
                         "and <= 256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{fn}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "expected float32, bfloat16 or float16, all alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous on "
                             f"{q.device}")
    if sq == 0 or sk == 0:
        raise ValueError(f"{fn}: empty sequence")
    return b, sq, sk, hq, hkv, d


def _bias_arg(fn, bias, q, b, hq, sq, sk):
    """(f32 bias with a unit last stride or None, its batch / head /
    query strides: 0 on broadcast dims)."""
    bias = _as_bias(bias, b, hq, sq, sk)
    if bias is None:
        return None, (0, 0, 0)
    if bias.device != q.device:
        raise ValueError(f"{fn}: bias on another device")
    if bias.stride(3) != 1:
        bias = bias.contiguous()
    return bias, tuple(bias.stride(i) for i in range(3))


def flash_fwd(q, k, v, bias=None, causal=False, head_major=False):
    """q [B,Sq,Hq,D]; k/v [B,Sk,Hkv,D] (Hq % Hkv == 0); bias optional,
    broadcastable to [B,Hq,Sq,Sk] (additive f32, or bool keep-mask).
    Returns (out [B,Sq,Hq,D], lse [B,Hq,Sq] f32).  head_major: q and out
    are [B,Hq,Sq,D] (the kernel's head-major mode, `flash_fwd_hm`; no
    bias).  The op ``paddle_tpu_torch::flash_fwd``: CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    _op.check_device("flash_fwd", q)
    return _flash_fwd_op(q, k, v, bias, bool(causal), bool(head_major))


def _flash_fwd_cuda(q, k, v, bias, causal, head_major):
    """The CUDA implementation of ``paddle_tpu_torch::flash_fwd``."""
    global launches
    b, sq, sk, hq, hkv, d = _check_qkv("flash_fwd", q, k, v, head_major)
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, device=q.device, dtype=torch.float32)
    if head_major:
        if bias is not None:
            raise ValueError("flash_fwd: head_major takes no bias (the kv "
                             "layout tier is unmasked)")
        lib = _build.library("flash_fwd", _SIG)
        err = lib.flash_fwd_hm(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse), b, sq, sk, hq, hkv, d, int(bool(causal)),
            1.0 / math.sqrt(d), _DTYPES[q.dtype],
            _build.stream_ptr(q.device))
        _build.check(err, "flash_fwd_hm")
        launches += 1
        return out, lse
    bias, strides = _bias_arg("flash_fwd", bias, q, b, hq, sq, sk)
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


def _flash_fwd_fake(q, k, v, bias, causal, head_major):
    b, hq, sq = (q.shape[:3] if head_major
                 else (q.shape[0], q.shape[2], q.shape[1]))
    return torch.empty_like(q), q.new_empty((b, hq, sq),
                                            dtype=torch.float32)


_flash_fwd_op = _op.define(
    "flash_fwd", "(Tensor q, Tensor k, Tensor v, Tensor? bias, bool causal, "
    "bool head_major) -> (Tensor, Tensor)", flash_fwd_reference,
    _flash_fwd_cuda, _flash_fwd_fake)


def flash_bwd(q, k, v, out, lse, dout, bias=None, causal=False,
              head_major=False, bias_grad=False):
    """Gradients of flash_fwd: q/out/dout [B,Sq,Hq,D], k/v [B,Sk,Hkv,D],
    lse [B,Hq,Sq] f32 (flash_fwd's), bias and causal as given to it.
    Returns (dq, dk, dv) in the inputs' layouts and dtype; with
    `bias_grad` (a floating bias) also dBias in the bias's shape and
    dtype (the kernels' dBias mode, given a dbias buffer: accumulated in
    f32, its broadcast axes summed).  head_major: q/out/dout/dq are
    [B,Hq,Sq,D] (the kernels' head-major mode, `flash_bwd_hm`; no bias).
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    global bwd_launches
    if bias_grad and (bias is None or not bias.is_floating_point()
                      or head_major):
        raise ValueError("flash_bwd: bias_grad needs a floating bias in "
                         "the native layout")
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, dout, bias, causal,
                                   head_major, bias_grad)
    b, sq, sk, hq, hkv, d = _check_qkv("flash_bwd", q, k, v, head_major)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_bwd: {name} must be a contiguous "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_bwd: lse must be a contiguous float32 "
                         f"{(b, hq, sq)} on {q.device}")
    delta = torch.empty(b, hq, sq, device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if head_major:
        if bias is not None:
            raise ValueError("flash_bwd: head_major takes no bias (the kv "
                             "layout tier is unmasked)")
        lib = _build.library("flash_bwd", _BWD_SIG)
        err = lib.flash_bwd_hm(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse), _build.ptr(dout), _build.ptr(delta),
            _build.ptr(dq), _build.ptr(dk), _build.ptr(dv), b, sq, sk, hq,
            hkv, d, int(bool(causal)), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
            _build.stream_ptr(q.device))
        _build.check(err, "flash_bwd_hm")
        bwd_launches += 1
        return dq, dk, dv
    mask = bias
    bias, strides = _bias_arg("flash_bwd", bias, q, b, hq, sq, sk)
    dbias, ds, unique = None, (0, 0, 0), 0
    if bias_grad:
        # the dBias mode: an f32 buffer of the mask's [mb, mh, mq, Sk]
        # shape (stride 0 on its broadcast axes), cast to the mask's
        # dtype at the end
        mb, mh, mq, _ = _bias_shape4(mask)
        dbias = torch.zeros(mb, mh, mq, sk, device=q.device,
                            dtype=torch.float32)
        ds = (mh * mq * sk if mb > 1 else 0, mq * sk if mh > 1 else 0,
              sk if mq > 1 else 0)
        unique = int(ds[2] != 0 and (ds[1] != 0 or hq == 1)
                     and (ds[0] != 0 or b == 1))
    lib = _build.library("flash_bwd", _BWD_SIG)
    err = lib.flash_bwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v),
        _build.ptr(bias) if bias is not None else None,
        _build.ptr(out), _build.ptr(lse), _build.ptr(dout),
        _build.ptr(delta), _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
        _build.ptr(dbias) if dbias is not None else None,
        b, sq, sk, hq, hkv, d, *strides, *ds, unique, int(bool(causal)),
        1.0 / math.sqrt(d), _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "flash_bwd")
    bwd_launches += 1
    if bias_grad:
        return dq, dk, dv, dbias.reshape(mask.shape).to(mask.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) through `flash_fwd`, differentiated by
    `flash_bwd` (the `_flash_core_flat` / `_flash_core_b` custom VJPs).
    A bias that needs its gradient gets it from the backward's dBias mode
    (JAX's `_flash_core_b_bwd` gives it none, :1616-1621, and sends such
    masks to `_sdpa_ref`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias=None, causal=False):
        out, lse = flash_fwd(q, k, v, bias=bias, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, bias = ctx.saved_tensors
        if ctx.needs_input_grad[3]:
            return flash_bwd(q, k, v, out, lse, dout.contiguous(),
                             bias=bias, causal=ctx.causal,
                             bias_grad=True) + (None,)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               bias=bias, causal=ctx.causal)
        return dq, dk, dv, None, None


class FlashAttentionKV(torch.autograd.Function):
    """The `kv` layout tier (``FLAGS_flash_layout=kv``), counterpart of
    `_flash_core_kv` (:1070-1091): Q goes head-major through
    `to_head_major`, the flash kernels run in their head-major mode, and
    O comes back through `from_head_major`; the backward moves dO in and
    dQ out the same way, with K, V, dK and dV native throughout.  Two
    relayouts each way per call; the numbers equal `FlashAttention`'s bit
    for bit (only the row addressing differs)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False):
        q_t = to_head_major(q)
        o_t, lse = flash_fwd(q_t, k, v, causal=causal, head_major=True)
        ctx.save_for_backward(q_t, k, v, o_t, lse)
        ctx.causal = causal
        return from_head_major(o_t)

    @staticmethod
    def backward(ctx, dout):
        q_t, k, v, o_t, lse = ctx.saved_tensors
        dq_t, dk, dv = flash_bwd(q_t, k, v, o_t, lse,
                                 to_head_major(dout.contiguous()),
                                 causal=ctx.causal, head_major=True)
        return from_head_major(dq_t), dk, dv, None
