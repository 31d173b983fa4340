"""Shared symmetric-int8 codec (``paddle_tpu/ops/quant.py`` counterpart).

One definition for every int8 tier of the port: the quantized KV page
pool (per-token, per-head vector scales) today; the weight tier
(per-output-channel scales) and the collective wire tier (per-chunk
scales) when they are ported.  The JAX module imports ``jax.numpy``, so
the port keeps its own copy of the same arithmetic.

Codec contract, pinned bit for bit against the JAX package by
``tests/test_torch_quant_kv.py``:

* ``scales_from_absmax``: scale = absmax / 127 in f32, except an
  all-zero block, whose scale is 1 so its codes decode to exact zeros
  (never 0 / 0).
* ``encode_int8``: ``clip(round(x / scale), -127, 127)`` with a true f32
  division (not a multiply by the reciprocal) and round half to even
  (`torch.round`, as `jnp.round`).
* The round trip errs by at most absmax / 127 of the block per element.
"""
from __future__ import annotations

import torch

__all__ = [
    "CHUNK", "scales_from_absmax", "encode_int8", "decode_int8",
    "quantize_chunked", "dequantize_chunked", "quantize_channels",
    "dequantize_channels", "quantize_vectors", "dequantize_vectors",
]

# per-chunk blocks of the wire tier
CHUNK = 256


def scales_from_absmax(absmax):
    """Per-block f32 scales from per-block absmax; an all-zero block
    gets scale 1.  The divisor is a tensor: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, and absmax * (1 / 127)
    is not always the f32 quotient absmax / 127 that the codec pins."""
    absmax = absmax.float()
    return torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                       1.0)


def encode_int8(x, scales):
    """Symmetric round-to-nearest encode of ``x`` under broadcastable
    ``scales``.  Returns the clipped values still in ``x``'s float
    dtype; callers cast to int8 themselves."""
    return torch.clamp(torch.round(x / scales), -127, 127)


def decode_int8(q, scales):
    """Inverse of `encode_int8`, in f32."""
    return q.float() * scales


# ----------------------- chunked (wire payloads) -----------------------


def _as_chunks(x, chunk):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, chunk), pad


def quantize_chunked(x, chunk=CHUNK):
    """Per-chunk int8 quantization.  Returns ``(q int8 [n_chunks,
    chunk], scales f32 [n_chunks], pad)``."""
    ch, pad = _as_chunks(x.float(), chunk)
    scales = scales_from_absmax(ch.abs().amax(dim=1))
    q = encode_int8(ch, scales[:, None]).to(torch.int8)
    return q, scales, pad


def dequantize_chunked(q, scales, shape, pad):
    """Inverse of `quantize_chunked` back to f32 ``shape``."""
    flat = decode_int8(q, scales[:, None]).reshape(-1)
    if pad:
        flat = flat[:flat.numel() - pad]
    return flat.reshape(shape)


# ----------------------- per-channel (weights) -----------------------


def quantize_channels(w, axis=0):
    """Per-channel quantization: absmax over ``axis``, one scale per
    remaining channel, kept broadcastable (size 1 on ``axis``).  Returns
    ``(q int8 (w.shape), scales f32)``."""
    w32 = w.float()
    scales = scales_from_absmax(w32.abs().amax(dim=axis, keepdim=True))
    return encode_int8(w32, scales).to(torch.int8), scales


def dequantize_channels(q, scales, dtype=torch.float32):
    """Inverse of `quantize_channels` into ``dtype`` (f32 multiply, one
    cast)."""
    return decode_int8(q, scales).to(dtype)


# ----------------------- per-vector (KV pages) -----------------------


def quantize_vectors(x):
    """Quantize the trailing dim of ``x`` as independent vectors, one
    scale per leading index (a KV head vector per token).  Returns
    ``(q int8 (x.shape), scales f32 x.shape[:-1])``."""
    x32 = x.float()
    scales = scales_from_absmax(x32.abs().amax(dim=-1))
    return encode_int8(x32, scales[..., None]).to(torch.int8), scales


def dequantize_vectors(q, scales, dtype=torch.float32):
    """Inverse of `quantize_vectors` into ``dtype``."""
    return decode_int8(q, scales[..., None]).to(dtype)
