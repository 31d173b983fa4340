"""Auto-regressive generation over static and paged KV caches.

Counterpart of ``paddle_tpu/models/generation.py``: the attention bodies
the model families call with a cache (`_static_cache_attention`,
`_paged_cache_attention`), position helpers, `init_kv_caches`, and greedy
`generate()`.  The JAX package compiles one prefill and one scanned
decode program; PyTorch runs the same steps eagerly, one model call per
token, and writes the caches IN PLACE (the JAX functions return updated
buffers; here the returned buffers are the same tensors).  Attention
runs through the port's kernels: `flash_fwd` for prefill (causal, with
a pad-key bias for left-padded rows), `decode_attention` for the
dense decode step, `paged_attention` for the engine's paged step (its
int8 kernel under the quantized KV tier).

Sampling and beam search are not ported yet (ROADMAP Queue A5).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..nn import functional as F
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.paged_attention import paged_attention
from ..ops.quant import quantize_vectors

# finite mask value of the JAX package (generation.py:170): a fully
# masked left-pad row stays finite instead of turning NaN
NEG_INF = -1e30

# --- warm (cached-prefix) tail prefill -------------------------------------
# Inside `warm_prefill_guard(P)` a multi-token cached forward is a WARM
# TAIL PREFILL: the dense cache buffers arrive holding a cached prefix
# at [0, P), the fresh tokens write at [P, P+S), and every query attends
# the prefix plus the causal fresh span.  Thread-local, as in the JAX
# package, so no model forward signature grows a parameter.
_WARM_PREFILL = threading.local()


@contextlib.contextmanager
def warm_prefill_guard(prefix_len):
    """`prefix_len`: int — cached prefix tokens already sitting in the
    dense cache buffers at [0, P)."""
    prev = getattr(_WARM_PREFILL, "value", None)
    _WARM_PREFILL.value = int(prefix_len)
    try:
        yield
    finally:
        _WARM_PREFILL.value = prev


def _is_row_vector(cache_pos) -> bool:
    return isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1


def _static_cache_attention(q, k, v, kv_cache, cache_pos, attn_start=None):
    """q [B,S,Hq,D]; k/v [B,S,Hkv,D]; kv_cache (k_buf, v_buf)
    [B,Hkv,cap,D] written in place at [cache_pos, cache_pos+S);
    cache_pos an int; attn_start optional [B] int32 — first non-pad
    position per row.  Prefill (S > 1) assumes cache_pos == 0 and
    attends the fresh K/V (causal, or through the pad mask); decode
    (S == 1) reads the cache through `decode_attention`, keys
    attn_start..cache_pos.  A 3-tuple cache ``(k_pages, v_pages,
    page_table)``, or the int8 tier's 5-tuple ``(k_pages, v_pages,
    page_table, k_scales, v_scales)``, with a [B] cache_pos routes to
    `_paged_cache_attention`.  Returns (out [B,S,Hq,D], kv_cache)."""
    if isinstance(kv_cache, (tuple, list)) and len(kv_cache) in (3, 5):
        return _paged_cache_attention(q, k, v, kv_cache, cache_pos)
    b, s, hq, d = q.shape
    kb, vb = kv_cache
    p = int(cache_pos)
    kb[:, :, p:p + s] = k.transpose(1, 2).to(kb.dtype)
    vb[:, :, p:p + s] = v.transpose(1, 2).to(vb.dtype)
    if s == 1:
        pos = torch.full((b,), p, dtype=torch.int32, device=q.device)
        out = decode_attention(q.reshape(b, hq, d).contiguous(), kb, vb,
                               pos, start=attn_start)
        return out.reshape(b, 1, hq, d), (kb, vb)
    # Prefill attention is causal (bottom-right aligned, so the kernel
    # skips the key blocks past the diagonal) plus, for left-padded rows,
    # a pad-only bias [B, 1, 1, Sk] that hides the pad keys.  Pad query
    # rows then see no valid key; the finite NEG_INF keeps them finite
    # and no real row reads them.
    wp = getattr(_WARM_PREFILL, "value", None)
    if wp is not None:
        # WARM tail prefill: keys come from the cache buffer — prefix at
        # [0, P) plus the tail just written at [P, P+S).  Keys past the
        # written span are cut off, so a bucketed prefix capacity never
        # leaks in; causal with off = Sk - Sq = P lets query row i attend
        # every prefix key and fresh keys j-P <= i, and the pad bias
        # drops fresh keys below the tail's start.
        kk = kb[:, :, :wp + s].transpose(1, 2).contiguous()  # [B,P+S,H,D]
        vv = vb[:, :, :wp + s].transpose(1, 2).contiguous()
        mask = None
        if attn_start is not None:
            j = torch.arange(wp + s, device=q.device)[None, :]
            valid = (j < wp) | (j - wp >= attn_start.long()[:, None])
            mask = torch.where(valid, 0.0, NEG_INF)[:, None, None]
        out = F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask,
                                             is_causal=True)
        return out, (kb, vb)
    mask = None
    if attn_start is not None:
        j = torch.arange(s, device=q.device)[None, :]       # key pos
        valid = j >= attn_start.long()[:, None]
        mask = torch.where(valid, 0.0, NEG_INF)[:, None, None]  # [B,1,1,S]
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         is_causal=True)
    return out, (kb, vb)


def _paged_cache_attention(q, k, v, kv_cache, cache_pos):
    """Paged decode attention (engine tier).  q [B,1,Hq,D]; k/v
    [B,1,Hkv,D]; kv_cache (k_pages, v_pages, page_table): pools
    [num_pages,Hkv,page_size,D], page_table [B,P] int32; cache_pos [B]
    int32, each row's write index.  The current token's K/V goes to
    (page_table[b, pos//ps], pos % ps) in place, then `paged_attention`
    attends keys 0..pos[b].  Free slots ride along with pos 0 and an
    all-scratch table: they all write page 0, slot 0.

    Quantized KV tier: a 5-tuple ``(k_pages, v_pages, page_table,
    k_scales, v_scales)`` with int8 pools and f32 scale tables
    [num_pages,Hkv,page_size].  Each fresh K/V head vector quantizes on
    its own (`quantize_vectors`: no neighbour is requantized, so a write
    stays one slot), its codes and scale go to the same slot in place,
    and `paged_attention` dequantizes inside the kernel."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if s != 1:
        raise ValueError(
            "paged KV cache serves single-token decode steps; prefill "
            "runs the dense path and packs into pages afterwards")
    quantized = len(kv_cache) == 5
    if quantized:
        kp, vp, pt, ks, vs = kv_cache
    else:
        kp, vp, pt = kv_cache
        ks = vs = None
    ps = kp.shape[2]
    pos = cache_pos
    rows = torch.arange(b, device=q.device)
    page_ids = pt[rows, (pos // ps).long()].long()
    slots = (pos % ps).long()
    k1, v1 = k.reshape(b, hkv, d), v.reshape(b, hkv, d)
    # plain indexed assignment, never accumulate=True: duplicate indices
    # (every free slot hits page 0, slot 0) then just leave one of the
    # writes — the scratch page's content is garbage by design
    if quantized:
        # K and V through one codec pass (each vector its own scale)
        codes, sc = quantize_vectors(torch.stack((k1, v1)))
        kp[page_ids, :, slots, :] = codes[0]        # [B,Hkv,D]
        vp[page_ids, :, slots, :] = codes[1]
        ks[page_ids, :, slots] = sc[0]              # [B,Hkv]
        vs[page_ids, :, slots] = sc[1]
    else:
        kp[page_ids, :, slots, :] = k1.to(kp.dtype)
        vp[page_ids, :, slots, :] = v1.to(vp.dtype)
    out = paged_attention(q.reshape(b, hq, d).contiguous(), kp, vp, pt,
                          pos, k_scales=ks, v_scales=vs)
    new_cache = (kp, vp, pt, ks, vs) if quantized else (kp, vp, pt)
    return out.reshape(b, 1, hq, d), new_cache


def decode_position_ids(cache_pos, b, s, attn_start=None, device=None):
    """[B, S] position ids for a cached forward: cache_pos an int (dense
    lockstep cache) or a [B] vector (paged ragged cache); left-pad shift
    applied when attn_start is given."""
    if _is_row_vector(cache_pos):
        pos = torch.arange(s, dtype=torch.int32, device=cache_pos.device)
        position_ids = cache_pos[:, None] + pos[None, :]
    else:
        pos = torch.arange(s, dtype=torch.int32, device=device)
        position_ids = (pos + int(cache_pos))[None, :].expand(b, s)
    return shift_positions(position_ids, attn_start)


def forward_phases(x, head_dim, kv_caches=None, cache_pos=None,
                   attn_start=None, base=10000.0):
    """The rotary (cos, sin) of one model forward of embeddings x [B, S,
    H], in x's dtype, computed once and handed to every layer (the rope
    families' attention rotates q and k by them).  Cached forwards
    continue from cache_pos (an int, or a [B] vector on the paged path);
    left-padded rows put their first real token at rotary position 0."""
    b, s, _ = x.shape
    position_ids = None if kv_caches is None else decode_position_ids(
        cache_pos, b, s, attn_start, device=x.device)
    return F.rotary_phases(head_dim, s, position_ids, base, x.device,
                           x.dtype)


def shift_positions(position_ids, attn_start):
    """Left-padded rows: each row's first real token sits at position 0
    (pad positions clip to 0)."""
    if attn_start is None:
        return position_ids
    return torch.clamp(position_ids - attn_start[:, None], min=0)


def init_kv_caches(num_layers, batch, num_heads, head_dim, max_len,
                   dtype=torch.float32, device=None):
    """Fixed-shape per-layer KV buffers [B, H, cap, D]; capacity rounds
    up to a multiple of 128 as in the JAX package (the tail is masked by
    position)."""
    cap = -(-int(max_len) // 128) * 128
    return [(torch.zeros(batch, num_heads, cap, head_dim, dtype=dtype,
                         device=device),
             torch.zeros(batch, num_heads, cap, head_dim, dtype=dtype,
                         device=device))
            for _ in range(num_layers)]


def _left_pad_starts(attention_mask, b, s0):
    """[B] first real position per row of a LEFT-padded 0/1 mask."""
    mh = np.asarray(attention_mask.cpu() if isinstance(
        attention_mask, torch.Tensor) else attention_mask).astype(np.int32)
    if mh.shape != (b, s0):
        raise ValueError(f"attention_mask must be [B, S0]={b, s0}, got "
                         f"{tuple(mh.shape)}")
    if not (mh[:, -1] == 1).all():
        raise ValueError(
            "attention_mask must be LEFT-padded (last column all ones): "
            "right padding would put a pad token at the next-token "
            "prediction position")
    starts = mh.argmax(axis=1)
    if not ((np.arange(s0)[None, :] >= starts[:, None])
            == mh.astype(bool)).all():
        raise ValueError("attention_mask must be contiguous left padding "
                         "(zeros then ones per row)")
    return starts


class GenerationMixin:
    """Mixed into *ForCausalLM models that implement
    `init_kv_caches(batch, max_len)` and
    `forward(ids, kv_caches=, cache_pos=, attn_start=) -> (logits,
    caches)`, and expose `device`."""

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 eos_token_id=None, attention_mask=None, num_beams=1):
        """Greedy decoding.  input_ids [B, S0] ints (tensor or array).
        Returns int32 [B, S0 + n_generated] on the model's device.  With
        eos_token_id, finished rows repeat eos and the loop stops once
        every row has finished.  attention_mask: optional [B, S0] 0/1
        mask for LEFT-padded prompts."""
        if do_sample or num_beams > 1:
            raise NotImplementedError(
                "sampling and beam search are not ported yet (ROADMAP "
                "Queue A5); paddle_tpu_torch generate() is greedy")
        dev = self.device
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(input_ids.cpu())
                                  if isinstance(input_ids, torch.Tensor)
                                  else np.asarray(input_ids))
            ids = ids.to(device=dev, dtype=torch.int32)
            b, s0 = ids.shape
            if max_new_tokens <= 0:
                return ids
            start = None
            if attention_mask is not None:
                start = torch.as_tensor(
                    _left_pad_starts(attention_mask, b, s0),
                    dtype=torch.int32).to(dev)
            caches = self.init_kv_caches(b, s0 + max_new_tokens)
            was_training = self.training
            self.eval()
            try:
                logits, caches = self(ids, kv_caches=caches, cache_pos=0,
                                      attn_start=start)
                tok = logits[:, -1].float().argmax(-1).to(torch.int32)
                finished = None
                if eos_token_id is not None:
                    finished = tok == eos_token_id
                out = [tok]
                for i in range(1, max_new_tokens):
                    if finished is not None and bool(finished.all()):
                        break
                    logits, caches = self(tok[:, None], kv_caches=caches,
                                          cache_pos=s0 + i - 1,
                                          attn_start=start)
                    tok = logits[:, -1].float().argmax(-1).to(torch.int32)
                    if finished is not None:
                        # frozen rows keep emitting eos
                        tok = torch.where(finished, eos_token_id, tok)
                        finished = finished | (tok == eos_token_id)
                    out.append(tok)
                return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
            finally:
                if was_training:
                    self.train()
