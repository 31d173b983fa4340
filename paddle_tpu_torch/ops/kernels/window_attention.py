"""Fused Swin window attention (forward): CUDA kernel wrapper + plain
version, and the window partition helpers.

Counterpart of ``paddle_tpu/ops/pallas/window_attention.py``
(`_fwd_kernel` :173, launched by `_fwd_pallas` :260; the jnp reference
`window_attention_ref` :106 with `_heads_attention` :80).  The kernel is
``csrc/window_attention.cu``: one block per (batch, window, head); it
reads q / k / v at their image positions and writes the output there,
so the cyclic shift and the partition / reverse move no data.  The JAX
package's window-row band, VMEM gate and autotune (`_tuned_band`,
`window_attention_available`) are TPU tiling and have no counterpart.

The backward kernel (`_bwd_pallas` :290) comes with the Swin-T train
slice: on a CUDA tensor, a `qkv` or `bias` that requires grad raises
rather than running the plain version.  On the CPU the plain version
runs, and autograd differentiates it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/window_attention.cu"
REPLACES = ("paddle_tpu/ops/pallas/window_attention.py:173 (_fwd_kernel, "
            "via _fwd_pallas :260)")

# kernel launches since the last reset (the plain paths never count)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"window_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
MAX_TOKENS = 256              # ws * ws: keys per softmax row
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


def _heads_attention(qkv_win, bias, mask_w, num_heads):
    """The JAX `_heads_attention` (:80) on [N, P, 3C] window tokens: f32
    logits of (q * hd**-0.5) . k, plus the bias and the window's mask,
    max-subtracted softmax, P.V; f32 [N, P, C]."""
    n, p, c3 = qkv_win.shape
    c = c3 // 3
    hd = c // num_heads
    qkv_h = qkv_win.reshape(n, p, 3, num_heads, hd).float()
    q, k, v = (qkv_h[:, :, i].transpose(1, 2) for i in range(3))
    s = torch.einsum("nhpd,nhqd->nhpq", q * hd ** -0.5, k) + bias[None]
    if mask_w is not None:
        nw = mask_w.shape[0]
        s = s.reshape(n // nw, nw, num_heads, p, p) \
            + mask_w[None, :, None].float()
        s = s.reshape(n, num_heads, p, p)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("nhpq,nhqd->nphd", probs, v).reshape(n, p, c)


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


def window_attention(qkv, bias, mask, window_size, shift, num_heads):
    """Shifted-window attention over the post-projection image qkv [B, H,
    W, 3C] with the dense rel-pos bias [heads, ws², ws²] and the shift
    mask [nW, ws², ws²] (or None).  Returns [B, H, W, C] in qkv's dtype.
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise (also for inputs that require grad: the backward kernel is not
    ported yet)."""
    global launches
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, window_size,
                                          shift, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device "
                         f"{qkv.device}")
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        raise NotImplementedError(
            "window_attention: the backward kernel (_bwd_pallas) comes with "
            "the Swin-T train slice (ROADMAP Queue A); on CUDA run the "
            "forward under torch.inference_mode() or torch.no_grad()")
    if qkv.dim() != 4:
        raise ValueError(f"window_attention: qkv must be [B, H, W, 3C], got "
                         f"{tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    ws = int(window_size)
    p = ws * ws
    if c3 % 3 or (c3 // 3) % num_heads or h % ws or w % ws or shift < 0:
        raise ValueError(f"window_attention: qkv {tuple(qkv.shape)} with "
                         f"{num_heads} heads, window {ws}, shift {shift}")
    c = c3 // 3
    hd = c // num_heads
    smem = (3 * p * (hd + 1) + p * p) * 4
    if p > MAX_TOKENS or smem > SMEM_LIMIT or not 1 <= b <= 65535:
        raise ValueError(f"window_attention: window {ws}, head_dim {hd}, "
                         f"batch {b} exceed the kernel's limits")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"window_attention: dtype {qkv.dtype}; expected "
                        "float32 or bfloat16")
    nw = (h // ws) * (w // ws)
    bias = bias.to(torch.float32).contiguous()
    if bias.shape != (num_heads, p, p) or bias.device != qkv.device:
        raise ValueError(f"window_attention: bias {tuple(bias.shape)} on "
                         f"{bias.device}, expected [{num_heads}, {p}, {p}]")
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
        if mask.shape != (nw, p, p) or mask.device != qkv.device:
            raise ValueError(f"window_attention: mask {tuple(mask.shape)} "
                             f"on {mask.device}, expected [{nw}, {p}, {p}]")
    qkv = qkv.contiguous()
    out = torch.empty(b, h, w, c, dtype=qkv.dtype, device=qkv.device)
    lib = _build.library("window_attention", _SIG)
    err = lib.window_attention(
        _build.ptr(qkv), _build.ptr(bias),
        None if mask is None else _build.ptr(mask), _build.ptr(out), b, h, w,
        c, num_heads, ws, int(shift), ctypes.c_float(hd ** -0.5),
        _DTYPES[qkv.dtype], _build.stream_ptr(qkv.device))
    _build.check(err, "window_attention")
    launches += 1
    return out
