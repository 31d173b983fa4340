"""Relayout between ``[B, S, H, D]`` and head-major ``[B, H, S, D]``: CUDA
kernel wrappers, plain versions, and the autograd functions that make
each direction the other's adjoint.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py`` `_to_hm`
(:1141) and `_from_hm` (:1161) with their custom VJPs (:1179-1196).  Both
kernels are in ``csrc/relayout.cu``; each counts on a counter of its own.
The `kv` flash layout tier (`FlashAttentionKV`) is their caller.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/relayout.cu"
TO_REPLACES = ("paddle_tpu/ops/pallas/flash_attention.py:1141 (_to_hm; "
               "kernel _relayout_kernel_to_hm :1110)")
FROM_REPLACES = ("paddle_tpu/ops/pallas/flash_attention.py:1161 (_from_hm; "
                 "kernel _relayout_kernel_from_hm :1123)")

to_launches = 0     # relayout_to_hm
from_launches = 0   # relayout_from_hm

_SIG = {fn: [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for fn in ("relayout_to_hm", "relayout_from_hm")}
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def to_head_major_reference(x):
    """Plain version: [B, S, H, D] -> [B, H, S, D], contiguous."""
    return x.transpose(1, 2).contiguous()


def from_head_major_reference(x):
    """Plain version: [B, H, S, D] -> [B, S, H, D], contiguous."""
    return x.transpose(1, 2).contiguous()


def _launch(fn, x):
    """Check x (4-d, f32, bf16 or f16, contiguous, on CUDA) and run `fn` of
    the relayout library into a new tensor with dims 1 and 2 swapped."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{fn}: expected a 4-d tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {x.dtype}; expected float32, "
                        "bfloat16 or float16")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    b, s1, s2, d = x.shape
    y = torch.empty(b, s2, s1, d, dtype=x.dtype, device=x.device)
    # to_hm: x is [B, S, H, D]; from_hm: x is [B, H, S, D]
    s, h = (s1, s2) if fn == "relayout_to_hm" else (s2, s1)
    lib = _build.library("relayout", _SIG)
    err = getattr(lib, fn)(_build.ptr(x), _build.ptr(y), b, s, h,
                           d * x.element_size(), _build.stream_ptr(x.device))
    _build.check(err, fn)
    return y


def to_head_major(x):
    """x [B, S, H, D] -> [B, H, S, D] (contiguous).  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    global to_launches
    if x.device.type == "cpu":
        return to_head_major_reference(x)
    y = _launch("relayout_to_hm", x)
    to_launches += 1
    return y


def from_head_major(x):
    """x [B, H, S, D] -> [B, S, H, D] (contiguous).  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    global from_launches
    if x.device.type == "cpu":
        return from_head_major_reference(x)
    y = _launch("relayout_from_hm", x)
    from_launches += 1
    return y


class ToHeadMajor(torch.autograd.Function):
    """`to_head_major`, differentiated by `from_head_major` (`_to_hm`'s
    custom VJP)."""

    @staticmethod
    def forward(ctx, x):
        return to_head_major(x)

    @staticmethod
    def backward(ctx, g):
        return from_head_major(g.contiguous())


class FromHeadMajor(torch.autograd.Function):
    """`from_head_major`, differentiated by `to_head_major` (`_from_hm`'s
    custom VJP)."""

    @staticmethod
    def forward(ctx, x):
        return from_head_major(x)

    @staticmethod
    def backward(ctx, g):
        return to_head_major(g.contiguous())
