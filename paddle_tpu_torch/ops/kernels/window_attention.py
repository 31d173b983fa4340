"""Fused Swin window attention, forward and backward: CUDA kernel
wrappers + plain versions, the `WindowAttentionCore` autograd function
over them, and the window partition helpers.

Counterpart of ``paddle_tpu/ops/pallas/window_attention.py``
(`_fwd_kernel` :173, launched by `_fwd_pallas` :260; `_bwd_kernel`
:201, launched by `_bwd_pallas` :290; the custom VJP of `_build_core`
:337; the jnp reference `window_attention_ref` :106 with
`_heads_attention` :80).  The forward kernel is
``csrc/window_attention.cu``: in bf16 and f16 one tensor-core tile per
window, a block walking a group of a (batch, head)'s windows; in f32, and
for bf16 / f16 windows past that tile, one block per (batch, window,
head).  The backward kernel is ``csrc/window_attention_bwd.cu``: one
block per (batch, head) walking that batch's windows (in bf16 and f16,
on the tensor cores, per group of windows), which replays the scores and writes dqkv
and a dbias partial per batch (and group), summed here as `_bwd_pallas`
sums its per-batch partials.  Both read and write at image positions,
so the cyclic shift and the partition / reverse move no data.  The JAX
package's window-row band, VMEM gate and autotune (`_tuned_band`,
`window_attention_available`) are TPU tiling and have no counterpart.

`window_attention` with a `qkv` or `bias` that requires grad runs
through `WindowAttentionCore`: on CUDA the forward kernel, then the
backward kernel; on the CPU their plain versions.  Without grad it is
the op ``paddle_tpu_torch::window_attention`` (`_op.py`), which an
exported program holds.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _op

SOURCE = "paddle_tpu_torch/csrc/window_attention.cu"
REPLACES = ("paddle_tpu/ops/pallas/window_attention.py:173 (_fwd_kernel, "
            "via _fwd_pallas :260)")
BWD_SOURCE = "paddle_tpu_torch/csrc/window_attention_bwd.cu"
BWD_REPLACES = ("paddle_tpu/ops/pallas/window_attention.py:201 "
                "(_bwd_kernel, via _bwd_pallas :290)")

# kernel launches since the last reset (the plain paths never count)
launches = 0        # forward
bwd_launches = 0    # backward

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIG = {"window_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
_BWD_SIG = {"window_attention_bwd": [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p],
            "window_attention_bwd_groups": [ctypes.c_int] * 6}
MAX_TOKENS = 256              # ws * ws: keys per softmax row
# bf16 and f16: one 64 x 64 tensor-core tile a window, head_dim <= 64
# and a multiple of 8 (the backward raises past it; the forward's launcher
# gives such windows to its CUDA-core kernel)
TC_DTYPES = (torch.bfloat16, torch.float16)
TC_MAX_TOKENS = 64
TC_MAX_HEAD_DIM = 64
SMEM_LIMIT = 227 * 1024       # a block's shared memory on the H100


def window_partition(x, ws):
    """[B, H, W, C] -> [B*nW, ws*ws, C] (row-major window order)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws, h, w):
    """[B*nW, ws*ws, C] -> [B, H, W, C], the inverse of
    `window_partition`."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _window_probs(qkv_win, bias, mask_w, num_heads):
    """The JAX `_heads_attention` (:80) up to the softmax, on [N, P, 3C]
    window tokens: f32 q, k, v [N, heads, P, hd] (q unscaled) and the
    probabilities [N, heads, P, P] of (q * hd**-0.5) . k plus the bias
    and the window's mask, max-subtracted."""
    n, p, c3 = qkv_win.shape
    hd = c3 // 3 // num_heads
    qkv_h = qkv_win.reshape(n, p, 3, num_heads, hd).float()
    q, k, v = (qkv_h[:, :, i].transpose(1, 2) for i in range(3))
    s = torch.einsum("nhpd,nhqd->nhpq", q * hd ** -0.5, k) + bias[None]
    if mask_w is not None:
        nw = mask_w.shape[0]
        s = s.reshape(n // nw, nw, num_heads, p, p) \
            + mask_w[None, :, None].float()
        s = s.reshape(n, num_heads, p, p)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True), q, k, v


def _heads_attention(qkv_win, bias, mask_w, num_heads):
    """The JAX `_heads_attention` (:80): P.V per window and head; f32
    [N, P, C]."""
    n, p, c3 = qkv_win.shape
    probs, _, _, v = _window_probs(qkv_win, bias, mask_w, num_heads)
    return torch.einsum("nhpq,nhqd->nphd", probs, v).reshape(n, p, c3 // 3)


def window_attention_reference(qkv, bias, mask, window_size, shift,
                               num_heads):
    """Plain version, the JAX `window_attention_ref`: roll by -shift,
    partition, biased (and masked) attention per window and head,
    reverse, roll back.  qkv [B, H, W, 3C]; bias [heads, P, P]; mask
    [nW, P, P] additive or None.  Returns [B, H, W, C] in qkv's
    dtype."""
    _, h, w, _ = qkv.shape
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    out = _heads_attention(window_partition(x, window_size), bias.float(),
                           mask, num_heads)
    out = window_reverse(out.to(qkv.dtype), window_size, h, w)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def window_attention_bwd_reference(qkv, bias, mask, g, window_size, shift,
                                   num_heads):
    """Plain backward, `_bwd_kernel`'s math (:201-257): per window and
    head, replay the probabilities P, then dV = P^T g, dP = g V^T, dS =
    P * (dP - rowsum(dP * P)), dQ = dS K * scale and dK = dS^T Q * scale
    (Q unscaled), all in f32.  g [B, H, W, C] is the output's cotangent.
    Returns (dqkv [B, H, W, 3C] in qkv's dtype, channels [dq | dk | dv]
    each [heads, hd]; dbias [heads, P, P] f32, dS summed over windows
    and batch).  The mask gets no gradient."""
    _, h, w, c3 = qkv.shape
    ws = window_size
    hd = c3 // 3 // num_heads
    scale = hd ** -0.5
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), (1, 2))
        g = torch.roll(g, (-shift, -shift), (1, 2))
    probs, q, k, v = _window_probs(window_partition(qkv, ws), bias.float(),
                                   mask, num_heads)
    n, p = probs.shape[0], probs.shape[-1]
    gw = window_partition(g, ws).float().reshape(n, p, num_heads, hd) \
        .transpose(1, 2)
    dv = torch.einsum("nhpq,nhpd->nhqd", probs, gw)
    dp = torch.einsum("nhpd,nhqd->nhpq", gw, v)
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    dq = torch.einsum("nhpq,nhqd->nhpd", ds, k) * scale
    dk = torch.einsum("nhpq,nhpd->nhqd", ds, q) * scale
    dwin = torch.stack([dq, dk, dv], dim=1)           # [N, 3, heads, P, hd]
    dwin = dwin.permute(0, 3, 1, 2, 4).reshape(n, p, c3)
    dqkv = window_reverse(dwin.to(qkv.dtype), ws, h, w)
    if shift:
        dqkv = torch.roll(dqkv, (shift, shift), (1, 2))
    return dqkv, ds.sum(dim=0)


def _checked(what, qkv, bias, mask, window_size, shift, num_heads, tiles):
    """The kernels' limits on CUDA inputs.  `tiles(p, hd)` is the block's
    shared memory in floats.  Returns (ws, head_dim, f32 contiguous bias,
    f32 contiguous mask or None, contiguous qkv)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qkv.device}")
    if qkv.dim() != 4:
        raise ValueError(f"{what}: qkv must be [B, H, W, 3C], got "
                         f"{tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    ws = int(window_size)
    p = ws * ws
    if c3 % 3 or (c3 // 3) % num_heads or h % ws or w % ws or shift < 0:
        raise ValueError(f"{what}: qkv {tuple(qkv.shape)} with "
                         f"{num_heads} heads, window {ws}, shift {shift}")
    hd = c3 // 3 // num_heads
    if p > MAX_TOKENS or tiles(p, hd) * 4 > SMEM_LIMIT \
            or not 1 <= b <= 65535:
        raise ValueError(f"{what}: window {ws}, head_dim {hd}, batch {b} "
                         "exceed the kernel's limits")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {qkv.dtype}; expected float32, "
                        "bfloat16 or float16")
    nw = (h // ws) * (w // ws)
    bias = bias.to(torch.float32).contiguous()
    if bias.shape != (num_heads, p, p) or bias.device != qkv.device:
        raise ValueError(f"{what}: bias {tuple(bias.shape)} on "
                         f"{bias.device}, expected [{num_heads}, {p}, {p}]")
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
        if mask.shape != (nw, p, p) or mask.device != qkv.device:
            raise ValueError(f"{what}: mask {tuple(mask.shape)} on "
                             f"{mask.device}, expected [{nw}, {p}, {p}]")
    return ws, hd, bias, mask, qkv.contiguous()


def window_attention(qkv, bias, mask, window_size, shift, num_heads):
    """Shifted-window attention over the post-projection image qkv [B, H,
    W, 3C] with the dense rel-pos bias [heads, ws², ws²] and the shift
    mask [nW, ws², ws²] (or None).  Returns [B, H, W, C] in qkv's dtype.
    When `qkv` or `bias` requires grad, through `WindowAttentionCore`
    (the forward and backward kernels on CUDA, their plain versions on
    the CPU); else the op ``paddle_tpu_torch::window_attention``: CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    _op.check_device("window_attention", qkv)
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return WindowAttentionCore.apply(qkv, bias, mask, window_size,
                                         shift, num_heads)
    return _window_attention_op(qkv, bias, mask, int(window_size),
                                int(shift), int(num_heads))


def _window_attention_cuda(qkv, bias, mask, window_size, shift, num_heads):
    """The CUDA implementation of ``paddle_tpu_torch::window_attention``."""
    global launches
    ws, hd, bias, mask, qkv = _checked(
        "window_attention", qkv, bias, mask, window_size, shift, num_heads,
        lambda p, hd: 3 * p * (hd + 1) + p * p)
    b, h, w, c3 = qkv.shape
    out = torch.empty(b, h, w, c3 // 3, dtype=qkv.dtype, device=qkv.device)
    lib = _build.library("window_attention", _SIG)
    err = lib.window_attention(
        _build.ptr(qkv), _build.ptr(bias),
        None if mask is None else _build.ptr(mask), _build.ptr(out), b, h, w,
        c3 // 3, num_heads, ws, int(shift), ctypes.c_float(hd ** -0.5),
        _DTYPES[qkv.dtype], _build.stream_ptr(qkv.device))
    _build.check(err, "window_attention")
    launches += 1
    return out


def _window_attention_fake(qkv, bias, mask, window_size, shift, num_heads):
    b, h, w, c3 = qkv.shape
    return qkv.new_empty((b, h, w, c3 // 3))


_window_attention_op = _op.define(
    "window_attention", "(Tensor qkv, Tensor bias, Tensor? mask, "
    "int window_size, int shift, int num_heads) -> Tensor",
    window_attention_reference, _window_attention_cuda,
    _window_attention_fake)


def window_attention_bwd(qkv, bias, mask, g, window_size, shift,
                         num_heads):
    """The backward of `window_attention`: g [B, H, W, C] in qkv's dtype
    -> (dqkv [B, H, W, 3C] in qkv's dtype, dbias [heads, P, P] f32).
    CPU tensors run the plain version; CUDA tensors launch the kernel,
    whose dbias partials [B * groups, heads, P, P] (one per batch and
    group of windows) are summed here, or raise.  bf16 and f16 run on
    the tensor cores and take windows of up to 64 tokens and head dims
    up to 64, multiples of 8."""
    global bwd_launches
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, mask, g,
                                              window_size, shift, num_heads)
    ws, hd, bias, mask, qkv = _checked(
        "window_attention_bwd", qkv, bias, mask, window_size, shift,
        num_heads, lambda p, hd: 4 * p * (hd + 1) + 3 * p * p)
    b, h, w, c3 = qkv.shape
    if g.shape != (b, h, w, c3 // 3) or g.dtype != qkv.dtype \
            or g.device != qkv.device:
        raise ValueError(f"window_attention_bwd: g {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}, expected "
                         f"[{b}, {h}, {w}, {c3 // 3}] {qkv.dtype}")
    if qkv.dtype in TC_DTYPES and (ws * ws > TC_MAX_TOKENS
                                   or hd > TC_MAX_HEAD_DIM or hd % 8):
        raise ValueError(f"window_attention_bwd: bf16 and f16 take windows "
                         f"of at most {TC_MAX_TOKENS} tokens and head_dim "
                         f"<= {TC_MAX_HEAD_DIM}, a multiple of 8; got "
                         f"window {ws}, head_dim {hd}")
    g = g.contiguous()
    dqkv = torch.empty_like(qkv)
    lib = _build.library("window_attention_bwd", _BWD_SIG)
    # per-(batch, window group) partials, summed below
    groups = lib.window_attention_bwd_groups(b, h, w, num_heads, ws,
                                             _DTYPES[qkv.dtype])
    partial = torch.empty(b * groups, num_heads, ws * ws, ws * ws,
                          dtype=torch.float32, device=qkv.device)
    err = lib.window_attention_bwd(
        _build.ptr(qkv), _build.ptr(bias),
        None if mask is None else _build.ptr(mask), _build.ptr(g),
        _build.ptr(dqkv), _build.ptr(partial), b, h, w, c3 // 3, num_heads,
        ws, int(shift), ctypes.c_float(hd ** -0.5), _DTYPES[qkv.dtype],
        _build.stream_ptr(qkv.device))
    _build.check(err, "window_attention_bwd")
    bwd_launches += 1
    return dqkv, partial.sum(dim=0)


class WindowAttentionCore(torch.autograd.Function):
    """out = window_attention(qkv, bias, mask) through the forward
    kernel, differentiated by the backward kernel (the custom VJP of
    `_build_core` :337).  Its residuals are qkv, bias and the mask, not
    the output; dbias comes back in bias's dtype, and the mask, a
    stop-gradient constant, gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, window_size, shift, num_heads):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.args = (window_size, shift, num_heads)
        return window_attention(qkv, bias, mask, window_size, shift,
                                num_heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, mask, g, *ctx.args)
        return dqkv, dbias.to(bias.dtype), None, None, None, None
