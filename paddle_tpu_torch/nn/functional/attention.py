"""scaled_dot_product_attention (``paddle_tpu/nn/functional/
attention.py:80`` counterpart; plain version `_sdpa_ref` :51), its
`flash_attention` (:123) and the `sdp_kernel` policy (:36), packed
attention `flash_attn_unpadded` (:133) and the rotary embedding
`fused_rotary_position_embedding` / `apply_rotary_pos_emb` (:211, :264).

Inputs are ``[batch, seq, heads, head_dim]`` as in the JAX package.  A
CPU tensor runs the plain version, which autograd differentiates; a
CUDA tensor runs `FlashAttention` (the `flash_fwd` kernel, differentiated
by the `flash_bwd` kernel), with the mask as its additive
bias when one is given (the JAX entry's grad-safe mask route, :92-97),
or, under ``FLAGS_flash_layout=kv``, `FlashAttentionKV` (the same kernels
in head-major mode between the relayout kernels).  A mask that requires
grad gets its gradient from the biased backward kernel's dBias mode
(JAX differentiates it through `_sdpa_ref` instead).  There is no
fallback from CUDA to the plain version: the plain `_sdpa_ref` runs on
the card only where `sdp_kernel` disables flash and enables math, as the
caller asked; with both disabled the call raises, as in JAX.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ...amp import gate as _amp
from ...ops.kernels.flash_attention import (
    FlashAttention, FlashAttentionKV, layout_flag,
)
from ...ops.kernels.rope import RoPE
from ...ops.kernels.varlen_attention import VarlenAttention

NEG_INF = -1e30

# sdp_kernel's policy (JAX :32): which tiers scaled_dot_product_attention
# may take; read at each call
_sdp_policy = {"math": True, "flash": True}


@contextlib.contextmanager
def sdp_kernel(enable_math=False, enable_flash=True,
               enable_mem_efficient=True):
    """Constrain scaled_dot_product_attention's tier inside the context
    (JAX :36): `enable_flash` or `enable_mem_efficient` allow the flash
    kernels (the card's only fused tier), `enable_math` the plain
    `_sdpa_ref`.  On the CPU there is no flash kernel, so a call there
    needs math, as in JAX."""
    global _sdp_policy
    old = _sdp_policy
    _sdp_policy = {"math": bool(enable_math),
                   "flash": bool(enable_flash or enable_mem_efficient)}
    try:
        yield
    finally:
        _sdp_policy = old


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


def flash_tier(query, key, attn_mask=None) -> str:
    """Which flash path a CUDA call takes, in the order of the JAX
    `flash_attention_fwd` (flash_attention.py:1793-1928): a mask goes to
    the biased native kernel ("biased", :1808); lengths not divisible by
    8 to the native kernel ("native"; JAX pads them through its
    transpose core); then ``FLAGS_flash_layout=kv`` to `FlashAttentionKV`
    ("kv").  Every other layout value (auto, flat, transpose, mh) only
    chooses how Mosaic tiles the same numbers, so it runs the native
    kernel.  The Mosaic VMEM gate of the kv tier (`_kv_native_ok`) has no
    counterpart."""
    if attn_mask is not None:
        return "biased"
    if query.shape[1] % 8 or key.shape[1] % 8:
        return "native"
    return "kv" if layout_flag() == "kv" else "native"


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over [B, S, H, D] inputs (JAX :80).  `dropout_p` and
    `training` are accepted and applied to nothing, on either device: the
    JAX entry passes no dropout to its flash kernels (:96-98) and its
    plain `_sdpa_ref` takes the rate and ignores it (:51-77), so the port
    keeps one function on the CPU and the card (ROADMAP C2.6).  On CUDA a
    mask that requires grad gets its gradient from the flash backward's
    dBias mode.  Under `amp.auto_cast` the op runs in the AMP dtype (its
    floating mask too, as the JAX gate casts it).  `sdp_kernel` chooses
    the tier (module docstring)."""
    op = "scaled_dot_product_attention"
    query, key, value, attn_mask = _amp.cast(op, query, key, value,
                                             attn_mask)
    if query.device.type == "cpu" or not _sdp_policy["flash"]:
        # the plain version: the CPU route, or the math tier the caller
        # chose with sdp_kernel; never a fallback from a kernel
        if not _sdp_policy["math"]:
            raise RuntimeError(
                "sdp_kernel: math backend disabled and the flash kernel is "
                + ("unavailable for this input (a CPU tensor)"
                   if _sdp_policy["flash"] else "also disabled"))
        return _amp.seen(op, _sdpa_ref(query, key, value, attn_mask,
                                         is_causal))
    q, k, v = query.contiguous(), key.contiguous(), value.contiguous()
    if flash_tier(q, k, attn_mask) == "kv":
        return _amp.seen(op, FlashAttentionKV.apply(q, k, v, is_causal))
    return _amp.seen(op, FlashAttention.apply(q, k, v, attn_mask,
                                                is_causal))


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """`scaled_dot_product_attention` with no mask (JAX :123): returns
    (out, None); the softmax is never materialized."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="",
                        training=True, name=None):
    """Packed ragged-batch attention (JAX :133): query [Tq, H, D],
    key / value [Tk, H, D], cu_seqlens_* [n + 1] cumulative lengths.
    Returns (out, None).  Runs `VarlenAttention` (the `varlen_fwd` and
    `varlen_bwd` kernels on CUDA, their plain versions on the CPU).  The
    JAX entry's refusals are kept: `return_softmax`, dropout while
    training, and causal with unequal packings, which is always checked
    here (the packings are concrete; on CUDA the check reads them back,
    one host sync per causal call).  `max_seqlen_*` are not needed: the
    kernels find each tile's segments in cu_seqlens, so no segment is
    cut at them.  `scale` None means 1 / sqrt(head_dim); an explicit
    scale applies in f32 inside the kernel."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded: return_softmax=True would materialize "
            "the T x T probabilities the fused kernel exists to avoid")
    if dropout and training:
        raise NotImplementedError(
            "flash_attn_unpadded: attention-probability dropout is not "
            "applied on the fused path; pass dropout=0 or training=False")
    dev = query.device
    cu_q = torch.as_tensor(cu_seqlens_q, device=dev).to(torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=dev).to(torch.int32)
    if causal and not (cu_q.shape == cu_k.shape
                       and bool(torch.equal(cu_q, cu_k))):
        raise NotImplementedError(
            "flash_attn_unpadded: causal=True requires identical "
            "cu_seqlens_q and cu_seqlens_k (per-sequence causal alignment "
            "across different packings is not supported)")
    out = VarlenAttention.apply(query.contiguous(), key.contiguous(),
                                value.contiguous(), cu_q.contiguous(),
                                cu_k.contiguous(), scale, bool(causal))
    return out, None


def _rope_phases(d, s, base, position_ids, device):
    """f32 neox phases concat(freqs, freqs) (JAX :224-238): [1, S, 1, D]
    for positions 0..S-1, or [B, S, 1, D] for `position_ids` [B, S]."""
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=device) / d))
    if position_ids is None:
        pos = torch.arange(s, dtype=torch.float32, device=device)[None]
    else:
        pos = position_ids.to(torch.float32)
    freqs = pos[:, :, None] * inv                          # [B|1, S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb)[:, :, None], torch.sin(emb)[:, :, None]


def rotary_phases(head_dim, seq_len, position_ids=None,
                  rotary_emb_base=10000.0, device=None, dtype=torch.float32):
    """(cos, sin) [B|1, S, 1, D] in `dtype`: the neox phases that
    `fused_rotary_position_embedding` computes when given none, the same
    ops on the same inputs.  A model computes them once a forward and
    hands them to every layer's `rotate_qk`."""
    cos, sin = _rope_phases(head_dim, seq_len, rotary_emb_base,
                            position_ids, device)
    return cos.to(dtype), sin.to(dtype)


def rotate_qk(q, k, phases):
    """q [B, S, Hq, D] and k [B, S, Hkv, D] rotated (neox style) by the
    (cos, sin) of `rotary_phases`: one `RoPE` launch for both, forward
    and backward.  The phases are cast to q's dtype first where they
    differ, as `fused_rotary_position_embedding` casts them (JAX
    :245-246): under `auto_cast` the forward's phases follow the f32
    hidden state while q and k leave their projection in the AMP
    dtype."""
    cos, sin = phases
    if cos.dtype != q.dtype:
        cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    return RoPE.apply(q, cos, sin, False, k)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """Rotate q (and k, v when given), each [B, S, H, D], by the rotary
    phases (JAX :212).  Without `cos`/`sin` the phases come from
    `rotary_emb_base`, per row when `position_ids` [B, S] is given (the
    left-pad-shifted decode positions); explicit `cos`/`sin` ([S', D] in
    any leading shape) are gathered by `position_ids`.  The f32 phases
    are cast to q's dtype first, as the JAX package does (:245-246).
    Both styles run through the rope kernel on CUDA (`RoPE`, which the
    backward sends through the kernel's adjoint); q and k rotate in one
    launch, v in its own."""
    if time_major:
        raise NotImplementedError(
            "fused_rotary_position_embedding: time_major=True ([S, B, ...]"
            " layout) is not supported — pass batch-major tensors")
    s, d = q.shape[1], q.shape[3]
    if position_ids is not None:
        position_ids = torch.as_tensor(position_ids, device=q.device)
    if sin is None or cos is None:
        cos, sin = _rope_phases(d, s, rotary_emb_base, position_ids,
                                q.device)
    else:
        cos, sin = (torch.as_tensor(p, device=q.device).reshape(1, -1, 1, d)
                    for p in (cos, sin))
        if position_ids is not None:
            ids = position_ids.long()
            cos, sin = (p[0, :, 0][ids][:, :, None] for p in (cos, sin))
    cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    interleaved = not use_neox_rotary_style
    if k is None:
        q = RoPE.apply(q, cos, sin, interleaved)
    else:
        q, k = RoPE.apply(q, cos, sin, interleaved, k)
    if v is not None:
        v = RoPE.apply(v, cos, sin, interleaved)
    return q, k, v


def apply_rotary_pos_emb(q, k, cos, sin, position_ids=None):
    out = fused_rotary_position_embedding(q, k, None, sin=sin, cos=cos,
                                          position_ids=position_ids)
    return out[0], out[1]
