"""MultiHeadAttention, TransformerEncoderLayer and TransformerEncoder
(``paddle_tpu/nn/layers_transformer.py:31``, ``:96`` and ``:140``
counterparts).

Attention goes through the port's `scaled_dot_product_attention` on
``[B, S, H, D]``: on the card the flash kernels, with a mask as their
stop-gradient additive bias (the biased tier, forward and backward),
and on the CPU the plain version.  A 3-D mask ``[B, Sq, Sk]`` gains a
head axis (JAX :72-73).  A `Cache` appends this call's keys and values
to the cached ones along S and returns the grown cache; a `StaticCache`
(cross-attention memory) replaces them.  The cached path is not causal,
as in the JAX package.  Parameter names and the ``[in, out]`` Linear
layout equal the JAX layers', and `TransformerEncoder` stacks deep
copies of its layer, so every layer starts from the same weights, as
there.  The decoder classes are not ported (ROADMAP A9).
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from . import functional as F
from .layers_common import Dropout, LayerList, LayerNorm, Linear


def _linear(in_features, out_features, weight_attr, bias_attr, kw):
    if weight_attr is not None:
        raise NotImplementedError(
            "weight_attr is not ported (ROADMAP Queue A9); the port draws "
            "Paddle's default initialiser from the layer's generator")
    return Linear(in_features, out_features, bias=bias_attr is not False,
                  **kw)


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr,
                              kw)
        self.k_proj = _linear(kdim, embed_dim, weight_attr, bias_attr, kw)
        self.v_proj = _linear(vdim, embed_dim, weight_attr, bias_attr, kw)
        self.out_proj = _linear(embed_dim, embed_dim, weight_attr,
                                bias_attr, kw)

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


class TransformerEncoderLayer(nn.Module):
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
                 layer_norm_eps=1e-5, *, device, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout if attn_dropout is not None
            else dropout, weight_attr=weight_attr, bias_attr=bias_attr,
            **kw)
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr, kw)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr, kw)
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


class TransformerEncoder(nn.Module):
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
