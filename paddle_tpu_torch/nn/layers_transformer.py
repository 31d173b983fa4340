"""MultiHeadAttention, the Transformer encoder and decoder layers and
stacks, and `Transformer` (``paddle_tpu/nn/layers_transformer.py``
counterpart: :31, :96, :140, :170, :237, :272).

Attention goes through the port's `scaled_dot_product_attention` on
``[B, S, H, D]``: on the card the flash kernels, with a mask as their
additive bias (the biased tier, forward and backward; a mask that
requires grad gets its gradient from the backward's dBias mode), and on
the CPU the plain version.  A 3-D mask ``[B, Sq, Sk]`` gains a head axis
(JAX :72-73).  A `Cache` appends this call's keys and values to the
cached ones along S and returns the grown cache; a `StaticCache`
(cross-attention memory) replaces them.  The cached path is not causal,
as in the JAX package: a decode step attends to every cached position.
Parameter names and the ``[in, out]`` Linear layout equal the JAX
layers', and the stacks hold deep copies of their layer, so every layer
starts from the same weights, as there.

`weight_attr` / `bias_attr` are one attribute for every Linear of a
layer, as in JAX, or Paddle's per-sublayer list: an encoder layer takes
[self-attention, feed-forward], a decoder layer [self-attention,
cross-attention, feed-forward] (a shorter list repeats its last entry).
"""
from __future__ import annotations

import collections
import copy
import math

import torch

from ..core.device import resolve_device
from . import functional as F
from .layer_base import Layer
from .layers_common import Dropout, LayerList, LayerNorm, Linear

__all__ = [
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
]


def _attrs(attr, n):
    """`attr` for each of n sublayer groups: a list or tuple gives its
    entries (its last repeated), anything else itself."""
    if isinstance(attr, (list, tuple)):
        return [attr[min(i, len(attr) - 1)] for i in range(n)]
    return [attr] * n


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _shape(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
        new_cache = None
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            new_cache = self.Cache(k, v)
        mask = attn_mask
        if mask is not None and mask.dim() == 3:
            mask = mask.unsqueeze(1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if cache is not None and new_cache is not None:
            return out, new_cache
        return out

    def gen_cache(self, key, value=None, type=None):
        """A `StaticCache` of `key` / `value` projected (``type=
        MultiHeadAttention.StaticCache``), else an empty `Cache`."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None
                                        else key))
            return self.StaticCache(k, v)
        k = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                        dtype=key.dtype, device=key.device)
        return self.Cache(k, k)


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual and
    a LayerNorm, before (``normalize_before``) or after.  Dropout as in
    the JAX layer: `dropout1` (rate `act_dropout`, default `dropout`) on
    the attention output, `dropout` on the activation, `dropout2` on the
    feed-forward output; `attn_dropout` (default `dropout`) is the
    attention's own rate, which `scaled_dot_product_attention` takes and
    applies to nothing (ROADMAP C2.6)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        kw = dict(device=device, dtype=dtype, generator=generator)
        wa, ba = _attrs(weight_attr, 2), _attrs(bias_attr, 2)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout if attn_dropout is not None
            else dropout, weight_attr=wa[0], bias_attr=ba[0], **kw)
        self.linear1 = Linear(d_model, dim_feedforward, wa[1], ba[1], **kw)
        self.linear2 = Linear(dim_feedforward, d_model, wa[1], ba[1], **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=device,
                               dtype=dtype)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=device,
                               dtype=dtype)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(act_dropout if act_dropout is not None
                                else dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """`num_layers` copies of `encoder_layer` (the first is the layer
    itself, the rest deep copies), then `norm` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention (masked by `tgt_mask`), cross-attention over the
    encoder's memory (masked by `memory_mask`) and a feed-forward block,
    each with a residual, a dropout and a LayerNorm, before or after
    (JAX :170).  A decode step passes ``cache = (Cache, StaticCache)``
    from `gen_cache` and gets the grown pair back."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        kw = dict(device=device, dtype=dtype, generator=generator)
        wa, ba = _attrs(weight_attr, 3), _attrs(bias_attr, 3)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, ad,
                                            weight_attr=wa[0],
                                            bias_attr=ba[0], **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, ad,
                                             weight_attr=wa[1],
                                             bias_attr=ba[1], **kw)
        self.linear1 = Linear(d_model, dim_feedforward, wa[2], ba[2], **kw)
        self.linear2 = Linear(dim_feedforward, d_model, wa[2], ba[2], **kw)
        nkw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **nkw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **nkw)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **nkw)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incr_cache = None
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                              None if cache is None else cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, cache[1]))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(Layer):
    """`num_layers` copies of `decoder_layer`, then `norm` when given
    (JAX :237)."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    """The encoder-decoder at Transformer-base's widths by default
    (d_model 512, 8 heads, 6 + 6 layers, feed-forward 2048, dropout 0.1;
    JAX :272).  `custom_encoder` / `custom_decoder` replace the stacks;
    with ``normalize_before`` each stack ends in a LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        kw = dict(device=device, dtype=dtype, generator=generator)
        nkw = dict(device=device, dtype=dtype)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            enc_norm = LayerNorm(d_model, **nkw) if normalize_before \
                else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            dec_norm = LayerNorm(d_model, **nkw) if normalize_before \
                else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] f32: 0 on and below the diagonal, -inf above
        (JAX :308), on `device` (the default device when None)."""
        return torch.triu(torch.full((length, length), -math.inf,
                                     device=resolve_device(device)), 1)
