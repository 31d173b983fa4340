"""incubate.nn.functional counterpart (``paddle_tpu/incubate/nn/
functional/__init__.py``): the fused norms, linears, activations,
dropout-add, the fused transformer functionals and the decode-step
attention functionals, each with the JAX function's conditions and
refusals copied literally.

`fused_rms_norm` / `fused_layer_norm` run `FusedNorm` (the `fused_norm`
kernel on CUDA, its plain version on the CPU; the backward plain, as the
JAX VJP's jnp backward).  Attention runs the port's
`scaled_dot_product_attention` (the flash kernels on CUDA); the large
matmuls are `torch.matmul`, as the JAX package leaves them to XLA.
Dropout is the port's `nn.functional.dropout`; the attention dropout
rate reaches the attention call, which applies it to nothing (ROADMAP
C2.6).

The decode step: `masked_multihead_attention` runs the `decode_attention`
kernel where the JAX function runs its Pallas kernel (no mask, head dim a
multiple of 8 up to 256, cache length a multiple of 8) and JAX's einsum
path otherwise; `block_multihead_attention`, `fused_ec_moe`, the
activations and the einsum path are plain torch, as their JAX bodies are
plain jnp.  `variable_length_memory_efficient_attention` runs
`FlashAttention` (the biased flash kernels on CUDA).  Both cache
functionals write the new token into the caches they are given and
return them, where JAX returns new arrays (ROADMAP C2.23).
"""
from __future__ import annotations

import math

import torch

from ....nn import functional as F
from ....nn.functional.attention import (  # noqa: F401
    fused_rotary_position_embedding,
)
from ....ops.kernels.decode_attention import decode_attention
from ....ops.kernels.flash_attention import FlashAttention
from ....ops.kernels.fused_norm import FusedNorm

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_rotary_position_embedding",
    "fused_bias_act", "fused_linear", "fused_linear_activation", "swiglu",
    "fused_matmul_bias", "fused_dropout_add", "masked_multihead_attention",
    "variable_length_memory_efficient_attention",
    "fused_multi_head_attention", "fused_feedforward",
    "fused_multi_transformer", "fused_bias_dropout_residual_layer_norm",
    "fused_ec_moe", "block_multihead_attention",
]


def _last_axis(fn, x, begin_norm_axis):
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            f"{fn}: begin_norm_axis={begin_norm_axis} is not supported; "
            "the fused norm normalises over the last axis only")


def _contig(t):
    return None if t is None else t.contiguous()


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kw):
    """bias + residual + RMS norm in one op (JAX :25).  Returns the norm,
    or (norm, x + bias + residual) when bias or residual is given."""
    if quant_scale not in (-1, None):
        raise NotImplementedError(
            "fused_rms_norm: quantized output (quant_scale) is not "
            "supported — quantize with nn.quant after the norm")
    _last_axis("fused_rms_norm", x, begin_norm_axis)
    return FusedNorm.apply(x.contiguous(), norm_weight, norm_bias, bias,
                           _contig(residual), epsilon, "rms")


def fused_layer_norm(x, norm_weight, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None, **kw):
    """bias + residual + LayerNorm in one op (JAX :60); returns as
    `fused_rms_norm`."""
    _last_axis("fused_layer_norm", x, begin_norm_axis)
    return FusedNorm.apply(x.contiguous(), norm_weight, norm_bias, bias,
                           _contig(residual), epsilon, "ln")


def _silu(v):
    return v * torch.sigmoid(v)


def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """act(x + bias) (JAX :92).  gelu is the tanh form, `jax.nn.gelu`'s
    default; an unknown `act_method` raises KeyError; `kw` is ignored."""
    if bias is not None:
        x = x + bias
    acts = {"gelu": lambda v: F.gelu(v, approximate=True),
            "relu": torch.relu,
            "silu": _silu,
            "swiglu": F.swiglu}
    return acts[act_method](x)


def swiglu(x, y=None, name=None):
    """silu(x) * y, or over the two halves of x's last axis (JAX :108)."""
    return F.swiglu(x, y)


def _T(x):
    """Every axis reversed (the JAX Tensor's `.T`)."""
    return x.permute(*range(x.dim() - 1, -1, -1))


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    if transpose_weight:
        weight = _T(weight)
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    if trans_x:
        # matrix-dims transpose only (fused_gemm_epilogue semantics)
        x = x.mT if x.dim() > 2 else _T(x)
    out = fused_linear(x, y, bias, trans_y)
    return {"gelu": F.gelu, "relu": F.relu}[activation](out)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    if transpose_x:
        x = _T(x)
    return fused_linear(x, y, bias, transpose_weight=transpose_y)


# the JAX functionals call `nn.functional.dropout` as `_dropout`
_dropout = F.dropout


def fused_dropout_add(x, y, p=0.0, training=True, mode="upscale_in_train",
                      name=None):
    return _dropout(x, p, training=training, mode=mode) + y


def _attention(q, k, v, attn_mask, dropout_p, training):
    """The JAX `_sdpa` call (:295-296): the attention dropout rate goes
    to `scaled_dot_product_attention`, which applies it to nothing on
    either package (ROADMAP C2.6)."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                          dropout_p=dropout_p,
                                          is_causal=False,
                                          training=training)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode='upscale_in_train',
                               ring_id=-1, add_residual=True, name=None):
    """qkv projection (packed [3, H, D, hidden] weight, ``transpose_y``)
    -> attention (not causal) -> output projection -> residual (+ LN), as
    JAX :262."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention: cache_kv decode is served by "
            "masked_multihead_attention / block_multihead_attention")
    residual = x
    # the JAX precedence: (pre_layer_norm and ln_scale) or pre_ln_scale
    if pre_layer_norm and ln_scale is not None or pre_ln_scale is not None:
        x = _first(fused_layer_norm(x, pre_ln_scale, pre_ln_bias,
                                    epsilon=pre_ln_epsilon))
    b, s, h = x.shape
    nh = qkv_weight.shape[1]
    hd = qkv_weight.shape[2]
    w = qkv_weight.reshape(3 * h, h)
    qkv = torch.matmul(x, w.mT)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(3 * h)
    qkv = qkv.reshape(b, s, 3, nh, hd)
    q, k, v = qkv.unbind(dim=2)
    out = _attention(q, k, v, attn_mask,
                     attn_dropout_rate if training else 0.0, training)
    out = torch.matmul(out.reshape(b, s, h), linear_weight)
    if linear_bias is not None:
        out = out + linear_bias
    if dropout_rate and training:
        out = _dropout(out, dropout_rate, mode=mode)
    if add_residual:
        out = out + residual
    if not pre_layer_norm and ln_scale is not None:
        out = _first(fused_layer_norm(out, ln_scale, ln_bias,
                                      epsilon=ln_epsilon))
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode='upscale_in_train', ring_id=-1, name=None):
    residual = x
    if pre_layer_norm and ln1_scale is not None:
        x = _first(fused_layer_norm(x, ln1_scale, ln1_bias,
                                    epsilon=ln1_epsilon))
    x = fused_linear_activation(x, linear1_weight, linear1_bias,
                                activation=activation)
    if dropout1_rate and training:
        x = _dropout(x, dropout1_rate, mode=mode)
    x = torch.matmul(x, linear2_weight)
    if linear2_bias is not None:
        x = x + linear2_bias
    if dropout2_rate and training:
        x = _dropout(x, dropout2_rate, mode=mode)
    x = x + residual
    if not pre_layer_norm and ln2_scale is not None:
        x = _first(fused_layer_norm(x, ln2_scale, ln2_bias,
                                    epsilon=ln2_epsilon))
    return x


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, time_step=None,
                            attn_mask=None, dropout_rate=0.0,
                            activation="gelu", training=False, mode=None,
                            trans_qkvw=True, ring_id=-1, name=None):
    """N pre-LN layers over per-layer weight lists (JAX :340)."""
    if cache_kvs is not None or time_step is not None:
        raise NotImplementedError(
            "fused_multi_transformer: cached decode is served by "
            "masked_multihead_attention / models.generate")
    if not trans_qkvw:
        raise NotImplementedError(
            "fused_multi_transformer: trans_qkvw=False (untransposed qkv "
            "weights) is not supported — pass [3, H, D, hidden] weights")
    out = x
    for i in range(len(qkv_weights)):
        out = fused_multi_head_attention(
            out, qkv_weights[i], linear_weights[i], pre_layer_norm=True,
            pre_ln_scale=ln_scales[i],
            pre_ln_bias=ln_biases[i] if ln_biases else None,
            qkv_bias=qkv_biases[i] if qkv_biases else None,
            linear_bias=linear_biases[i] if linear_biases else None,
            attn_mask=attn_mask, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate, training=training,
            pre_ln_epsilon=epsilon, ln_epsilon=epsilon)
        out = fused_feedforward(
            out, ffn1_weights[i], ffn2_weights[i],
            linear1_bias=ffn1_biases[i] if ffn1_biases else None,
            linear2_bias=ffn2_biases[i] if ffn2_biases else None,
            ln1_scale=ffn_ln_scales[i],
            ln1_bias=ffn_ln_biases[i] if ffn_ln_biases else None,
            dropout1_rate=dropout_rate, dropout2_rate=dropout_rate,
            activation=activation, pre_layer_norm=True, training=training,
            ln1_epsilon=epsilon)
    return out


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5,
                                           ln_epsilon=1e-5, training=True,
                                           mode='upscale_in_train',
                                           name=None):
    if bias is not None:
        x = x + bias
    if dropout_rate and training:
        x = _dropout(x, dropout_rate, mode=mode)
    return _first(fused_layer_norm(x, ln_scale, ln_bias, epsilon=ln_epsilon,
                                   residual=residual))


def decode_kernel_takes(cache_shape) -> bool:
    """The shapes the `decode_attention` kernel takes, JAX's
    `decode_attention_available` (ops/pallas/decode_attention.py:31):
    head dim a multiple of 8 up to 256, cache length a multiple of 8."""
    _, _, _, s, d = cache_shape
    return d % 8 == 0 and d <= 256 and s % 8 == 0


def masked_multihead_attention(x, cache_kv=None, src_mask=None,
                               sequence_lengths=None, rotary_embs=None,
                               beam_cache_offset=None, qkv_out_scale=None,
                               out_shift=None, out_smooth=None, seq_len=1,
                               rotary_emb_dims=0, use_neox_rotary_style=False,
                               compute_dtype="default", name=None):
    """One decode step over a dense KV cache (JAX :143).

    x: [B, 3*H*D] fused qkv of the current token; cache_kv: [2, B, H, S,
    D]; sequence_lengths: [B] tokens already cached (the write row).
    The new k / v go to row sequence_lengths[b] of cache_kv[0] / [1], in
    place.  With no `src_mask` and a shape the kernel takes, attention
    runs `decode_attention` (the kernel on CUDA, its plain version on the
    CPU); otherwise JAX's einsum path: scores in the input dtype, the
    float32-min fill, the mask added as [B, 1, S], softmax in f32, P in
    the cache dtype.  Returns (out [B, H*D], cache_kv), the same cache
    tensor (ROADMAP C2.23)."""
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    unsupported = {"rotary_embs": rotary_embs,
                   "beam_cache_offset": beam_cache_offset,
                   "qkv_out_scale": qkv_out_scale, "out_shift": out_shift,
                   "out_smooth": out_smooth}
    bad = [k for k, v in unsupported.items() if v is not None]
    if rotary_emb_dims:
        bad.append("rotary_emb_dims")
    if bad:
        raise NotImplementedError(
            f"masked_multihead_attention: {bad} not supported yet — apply "
            "RoPE before the qkv fuse (models.llama does) and dequant "
            "outside")
    _, B, H, S, D = cache_kv.shape
    if sequence_lengths is None:
        raise ValueError("sequence_lengths ([B] int32 write positions) is "
                         "required in this implementation")
    q, k, v = x.reshape(B, 3, H, D).unbind(1)
    dev = cache_kv.device
    pos = sequence_lengths.reshape(-1).to(device=dev, dtype=torch.int32)
    bidx = torch.arange(B, device=dev)
    kcache, vcache = cache_kv[0], cache_kv[1]
    kcache[bidx, :, pos] = k.to(kcache.dtype)
    vcache[bidx, :, pos] = v.to(vcache.dtype)
    if src_mask is None and decode_kernel_takes(cache_kv.shape):
        out = decode_attention(q.contiguous(), kcache, vcache, pos)
        return out.reshape(B, H * D), cache_kv
    valid = torch.arange(S, device=dev)[None, None, :] \
        <= pos[:, None, None]                                  # [B,1,S]
    # the f32 scale cast to q's dtype; the einsum in the promoted dtype
    scale = (1.0 / torch.sqrt(torch.tensor(float(D)))).to(q.dtype)
    ct = torch.promote_types(q.dtype, kcache.dtype)
    scores = torch.einsum("bhd,bhsd->bhs", q.to(ct), kcache.to(ct)) \
        * scale.to(dev)
    neg = torch.tensor(torch.finfo(torch.float32).min).to(scores.dtype)
    scores = torch.where(valid, scores, neg.to(dev))
    if src_mask is not None:
        scores = scores + src_mask.reshape(B, 1, -1)[:, :, :S]
    p = torch.softmax(scores.float(), dim=-1).to(vcache.dtype)
    out = torch.einsum("bhs,bhsd->bhd", p, vcache)
    return out.reshape(B, H * D), cache_kv


# The key-length mask's fill.  JAX adds -1e30 (:240); the flash kernels
# and their plain version *set* a causally hidden score to -1e30, where
# JAX's reference adds to it, so in a row with no valid key the two fills
# would tie.  A decade less keeps JAX's result: a hidden key still gets a
# weight of exactly 0 wherever a row has a valid key, and a row with
# none averages the causally visible value rows, as JAX's does (ROADMAP
# C2.25).
_KV_PAD = -1e29


def variable_length_memory_efficient_attention(query, key, value,
                                               seq_lens=None,
                                               kv_seq_lens=None, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0):
    """Attention over [B, H, S, D] inputs with per-row key lengths (JAX
    :214, `_ref_attention`'s function): keys at or past kv_seq_lens[b]
    get the additive fill; `mask` is cast to f32 and added (a bool mask
    adds 1.0 / 0.0, as in JAX); an explicit `scale` is folded into q in
    q's dtype; `causal` is aligned bottom-right; `seq_lens` and
    `pre_cache_length` are ignored, as in JAX.  Runs `FlashAttention`
    (the biased flash kernels on CUDA, their plain versions on the CPU),
    below the AMP gate: the JAX op is on no AMP list.  A mask that
    requires grad gets its gradient."""
    b, _, _, d = query.shape
    sk = key.shape[2]
    q = query
    if scale is not None:
        q = q * torch.tensor(scale * math.sqrt(d), dtype=q.dtype,
                             device=q.device)
    bias = None
    if mask is not None:
        # a mask that requires grad gets it from the flash backward's
        # dBias mode (JAX differentiates `_ref_attention` instead)
        bias = mask.to(device=q.device, dtype=torch.float32)
    if kv_seq_lens is not None:
        valid = torch.arange(sk, device=q.device)[None, None, None, :] \
            < kv_seq_lens.to(q.device).reshape(b, 1, 1, 1)
        pad = torch.where(valid, 0.0, _KV_PAD)
        bias = pad if bias is None else bias + pad
    out = FlashAttention.apply(q.transpose(1, 2).contiguous(),
                               key.transpose(1, 2).contiguous(),
                               value.transpose(1, 2).contiguous(), bias,
                               causal)
    return out.transpose(1, 2)


def _broadcast_add(a, b, fn):
    """a + b with numpy's broadcasting, the JAX bodies' bare `+`: shapes
    that do not broadcast raise ValueError, as jnp's do."""
    try:
        torch.broadcast_shapes(a.shape, b.shape)
    except RuntimeError:
        raise ValueError(f"{fn}: Incompatible shapes for broadcasting: "
                         f"{tuple(a.shape)}, {tuple(b.shape)}") from None
    return a + b


def _moe(x, gate_logits, w1, b1, w2, b2, act_type, fn):
    """The expert-choice MoE body of JAX's `fused_ec_moe` (:403-410) and
    `FusedEcMoe.forward` (layers.py:296-305): `b1` / `b2` are added to
    the [E, B, S, *] products as given."""
    probs = torch.softmax(gate_logits, dim=-1)                 # [B,S,E]
    h = _broadcast_add(torch.einsum("bsh,ehi->ebsi", x, w1), b1, fn)
    h = F.gelu(h, approximate=True) if act_type == "gelu" \
        else torch.relu(h)
    out = _broadcast_add(torch.einsum("ebsi,eih->ebsh", h, w2), b2, fn)
    return torch.einsum("ebsh,bse->bsh", out, probs.to(out.dtype))


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu"):
    """Expert-choice MoE (JAX :398): x [B, S, H], gate logits [B, S, E],
    weights [E, H, I] / [E, I, H].  The biases are added bare, as in JAX:
    the documented [E, 1, I] shape broadcasts against the batch axis, so
    it raises unless E == B (then expert b's bias goes to batch b); a
    [E, 1, 1, I] bias gives the layer's result (ROADMAP C2.24).  gelu is
    the tanh form; any other `act_type` is relu."""
    return _moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                act_type, "fused_ec_moe")


def block_multihead_attention(qkv, key_cache, value_cache,
                              seq_lens_encoder, seq_lens_decoder,
                              seq_lens_this_time, padding_offsets=None,
                              cum_offsets=None, cu_seqlens_q=None,
                              cu_seqlens_k=None, block_tables=None,
                              pre_key_cache=None, pre_value_cache=None,
                              cache_k_quant_scales=None,
                              cache_v_quant_scales=None,
                              cache_k_dequant_scales=None,
                              cache_v_dequant_scales=None,
                              qkv_out_scale=None, qkv_bias=None,
                              out_shift=None, out_smooth=None,
                              max_enc_len_this_time=None,
                              max_dec_len_this_time=None, rope_emb=None,
                              mask=None, tgt_mask=None, max_seq_len=-1,
                              block_size=64, use_neox_style=False,
                              name=None, **kwargs):
    """One decode step over a block (paged) KV cache (JAX :415), in
    plain torch with f32 math as JAX's jnp body: the new token's k / v go
    to slot seq_lens_decoder[b] % bs of block
    block_tables[b, seq_lens_decoder[b] // bs], in place; attention runs
    over each sequence's gathered blocks, keys 0..seq_lens_decoder[b].
    qkv: [B, 3*H*D]; key_cache / value_cache: [num_blocks, H, bs, D].
    Returns (out [B, H*D], key_cache, value_cache), the same cache
    tensors (ROADMAP C2.23).  A prefill batch (a seq_lens_encoder value
    > 0) raises NotImplementedError."""
    if any(s is not None for s in (cache_k_quant_scales,
                                   cache_v_quant_scales,
                                   cache_k_dequant_scales,
                                   cache_v_dequant_scales, qkv_out_scale,
                                   out_shift, out_smooth)):
        raise NotImplementedError(
            "block_multihead_attention: int8/smooth-quant cache scales "
            "are not supported (no int8 cache tier in this build)")
    if rope_emb is not None or tgt_mask is not None or \
            pre_key_cache is not None or pre_value_cache is not None:
        raise NotImplementedError(
            "block_multihead_attention: rope_emb/tgt_mask/pre-caches are "
            "not supported — apply RoPE before the qkv fuse and use "
            "mask= for attention masking")
    if seq_lens_encoder is not None and bool((seq_lens_encoder > 0).any()):
        raise NotImplementedError(
            "block_multihead_attention: prefill (nonzero "
            "seq_lens_encoder) is not supported — prefill with the dense "
            "flash path, decode here")
    kc, vc = key_cache, value_cache
    b = qkv.shape[0]
    _, h, bs, d = kc.shape
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(-1)
    q, k_new, v_new = qkv.reshape(b, 3, h, d).unbind(1)
    bt = block_tables.to(device=kc.device, dtype=torch.long)
    lens = seq_lens_decoder.reshape(-1).to(device=kc.device,
                                           dtype=torch.long)
    phys = bt.gather(1, (lens // bs)[:, None])[:, 0]
    slot = lens % bs
    kc[phys, :, slot] = k_new.to(kc.dtype)
    vc[phys, :, slot] = v_new.to(vc.dtype)
    s_max = bt.shape[1] * bs
    kseq = kc[bt].movedim(2, 1).reshape(b, h, s_max, d)
    vseq = vc[bt].movedim(2, 1).reshape(b, h, s_max, d)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kseq.float()) \
        * (1.0 / d ** 0.5)
    valid = torch.arange(s_max, device=kc.device)[None, :] <= lens[:, None]
    logits = torch.where(valid[:, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", probs, vseq.float())
    return out.reshape(b, h * d).to(qkv.dtype), kc, vc
