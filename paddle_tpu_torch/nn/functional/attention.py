"""scaled_dot_product_attention (``paddle_tpu/nn/functional/
attention.py:80`` counterpart; plain version `_sdpa_ref` :51).

Inputs are ``[batch, seq, heads, head_dim]`` as in the JAX package.  A
CPU tensor runs the plain version, which autograd differentiates; a
CUDA tensor runs `FlashAttention` (the `flash_fwd` kernel, differentiated
by the `flash_bwd` kernel), with the mask as its stop-gradient additive
bias when one is given (the JAX entry's grad-safe mask route, :92-97).
There is no fallback from CUDA to the plain version.
"""
from __future__ import annotations

import math

import torch

from ...ops.kernels.flash_attention import FlashAttention

NEG_INF = -1e30


def _sdpa_ref(q, k, v, attn_mask, is_causal, scale=None):
    """Plain version, same arithmetic as the JAX package's `_sdpa_ref`:
    scores in q's dtype, softmax in f32, probabilities back in q's
    dtype; GQA heads expand (consecutive groups)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(keep, logits, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, NEG_INF)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False):
    """Attention dropout is not ported.  On CUDA a mask that requires
    grad raises: the kernel gives the bias no gradient (the JAX entry
    sends such masks to its reference path instead)."""
    if query.device.type == "cpu":
        return _sdpa_ref(query, key, value, attn_mask, is_causal)
    if attn_mask is not None and attn_mask.requires_grad \
            and torch.is_grad_enabled():
        raise NotImplementedError(
            "scaled_dot_product_attention: a trainable attn_mask needs a "
            "bias gradient, which the flash kernels do not compute; "
            "detach the mask")
    return FlashAttention.apply(query.contiguous(), key.contiguous(),
                                value.contiguous(), attn_mask, is_causal)
