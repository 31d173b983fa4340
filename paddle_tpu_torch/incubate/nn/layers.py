"""incubate.nn fused layers (``paddle_tpu/incubate/nn/layers.py``
counterpart): `FusedLinear` :31, `FusedDropoutAdd` :50,
`FusedBiasDropoutResidualLayerNorm` :64, `FusedMultiHeadAttention` :90,
`FusedFeedForward` :160, `FusedTransformerEncoderLayer` :212,
`FusedMultiTransformer` :233 and `FusedEcMoe` :270.

Parameter names and shapes are the JAX layers', so `load_reference_state`
moves ``functional_state()`` across without transposes: `qkv_weight` is
``[3, heads, head_dim, embed]`` (applied with ``transpose_y``), the other
weights ``[in, out]``.  Initialisers are the JAX package's defaults
(`create_parameter` with no initializer: U(-1/sqrt(fan_in),
1/sqrt(fan_in)) with the JAX fans, zero biases, unit norm scales), drawn
from a generator seeded with `seed` on the layer's device.  Each layer
runs on the CUDA device unless `device` names another, as every entry
point of the port does.  Dropout with p > 0 raises in training (the
layers' default rates are the JAX ones: pass 0 to train).

`FusedMultiTransformer` attends with ``is_causal=False`` as the JAX
layer does (:143), though its docstring says causal.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.device import resolve_device
from ...nn import Linear
from ...nn.layer_base import Layer
from . import functional as IF

__all__ = [
    "FusedLinear", "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
    "FusedMultiHeadAttention", "FusedFeedForward",
    "FusedTransformerEncoderLayer", "FusedMultiTransformer", "FusedEcMoe",
]


def _fan_in(shape):
    """The JAX `_fans` fan-in: shape[0] for 1-D and 2-D shapes,
    shape[1] * prod(shape[2:]) beyond."""
    if len(shape) <= 2:
        return shape[0]
    return shape[1] * math.prod(shape[2:])


class _Fused(Layer):
    """Holds the device, dtype and generator its parameters are drawn
    with (`kw`, handed down to sublayers)."""

    def __init__(self, kw):
        super().__init__()
        self._kw = kw

    def param(self, shape, is_bias=False, ones=False):
        kw = self._kw
        t = torch.empty(shape, device=kw["device"], dtype=kw["dtype"])
        if ones:
            t.fill_(1.0)
        elif is_bias:
            t.zero_()
        else:
            bound = 1.0 / math.sqrt(_fan_in(shape))
            t.uniform_(-bound, bound, generator=kw["generator"])
        return nn.Parameter(t)


def _options(device, dtype, seed, kw):
    """Parameter options: `kw` of an enclosing layer, or new ones from
    (device, dtype, seed)."""
    if kw is not None:
        return kw
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return dict(device=dev, dtype=dtype, generator=gen)


class FusedLinear(_Fused):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device=None, dtype=torch.float32, seed=0, kw=None):
        super().__init__(_options(device, dtype, seed, kw))
        self.transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = self.param(shape)
        self.bias = None if bias_attr is False \
            else self.param([out_features], is_bias=True)

    def forward(self, x):
        return IF.fused_linear(x, self.weight, self.bias,
                               transpose_weight=self.transpose_weight)


class FusedDropoutAdd(Layer):
    """y = x + dropout(residual-input) in one fused op."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return IF.fused_dropout_add(x, y, p=self.p, training=self.training,
                                    mode=self.mode)


class FusedBiasDropoutResidualLayerNorm(_Fused):
    """out = layer_norm(residual + dropout(x + bias)) in one pass."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=torch.float32, seed=0, kw=None):
        super().__init__(_options(device, dtype, seed, kw))
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.ln_scale = self.param([embed_dim], ones=True)
        self.ln_bias = self.param([embed_dim], is_bias=True)
        self.linear_bias = self.param([embed_dim], is_bias=True)

    def forward(self, x, residual):
        if self.dropout_rate and self.training:
            x = IF._dropout(x + self.linear_bias, self.dropout_rate)
            out = IF.fused_layer_norm(
                x, self.ln_scale, self.ln_bias, epsilon=self.epsilon,
                residual=residual)
        else:
            out = IF.fused_layer_norm(
                x, self.ln_scale, self.ln_bias, epsilon=self.epsilon,
                bias=self.linear_bias, residual=residual)
        return IF._first(out)


class FusedMultiHeadAttention(_Fused):
    """Pre/post-LN fused self-attention block: qkv projection -> flash
    attention (not causal) -> output projection -> dropout + residual
    (+ LN)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, transpose_qkv_wb=False, name=None,
                 *, device=None, dtype=torch.float32, seed=0, kw=None):
        super().__init__(_options(device, dtype, seed, kw))
        if need_weights:
            raise ValueError("need_weights is not supported (reference)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.qkv_weight = self.param([3, num_heads, self.head_dim,
                                      embed_dim])
        self.qkv_bias = None if qkv_bias_attr is False else \
            self.param([3, num_heads, self.head_dim], is_bias=True)
        self.linear_weight = self.param([embed_dim, embed_dim])
        self.linear_bias = None if linear_bias_attr is False else \
            self.param([embed_dim], is_bias=True)
        self.pre_ln_scale = self.param([embed_dim], ones=True)
        self.pre_ln_bias = self.param([embed_dim], is_bias=True)
        self.ln_scale = self.param([embed_dim], ones=True)
        self.ln_bias = self.param([embed_dim], is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        x = query
        residual = x
        if self.normalize_before:
            x = IF._first(IF.fused_layer_norm(
                x, self.pre_ln_scale, self.pre_ln_bias,
                epsilon=self.epsilon))
        b, s, h = x.shape
        # qkv: [B, S, 3 * H * D] through the [3, H, D, hidden] weight
        w = self.qkv_weight.reshape(3 * h, h)
        qkv = torch.matmul(x, w.mT)
        if self.qkv_bias is not None:
            qkv = qkv + self.qkv_bias.reshape(3 * h)
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        out = IF._attention(
            q, k, v, attn_mask,
            self.attn_dropout_rate if self.training else 0.0, self.training)
        out = torch.matmul(out.reshape(b, s, h), self.linear_weight)
        if self.linear_bias is not None:
            out = out + self.linear_bias
        if self.dropout_rate and self.training:
            out = IF._dropout(out, self.dropout_rate)
        out = out + residual
        if not self.normalize_before:
            out = IF._first(IF.fused_layer_norm(
                out, self.ln_scale, self.ln_bias, epsilon=self.epsilon))
        return out


class FusedFeedForward(_Fused):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None, *,
                 device=None, dtype=torch.float32, seed=0, kw=None):
        super().__init__(_options(device, dtype, seed, kw))
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.activation = activation
        self.epsilon = epsilon
        self.linear1_weight = self.param([d_model, dim_feedforward])
        self.linear1_bias = self.param([dim_feedforward], is_bias=True)
        self.linear2_weight = self.param([dim_feedforward, d_model])
        self.linear2_bias = self.param([d_model], is_bias=True)
        self.ln1_scale = self.param([d_model], ones=True)
        self.ln1_bias = self.param([d_model], is_bias=True)
        self.ln2_scale = self.param([d_model], ones=True)
        self.ln2_bias = self.param([d_model], is_bias=True)

    def forward(self, src, cache=None):
        residual = src
        x = src
        if self.normalize_before:
            x = IF._first(IF.fused_layer_norm(
                x, self.ln1_scale, self.ln1_bias, epsilon=self.epsilon))
        x = IF.fused_linear_activation(
            x, self.linear1_weight, self.linear1_bias,
            activation=self.activation)
        if self.act_dropout_rate and self.training:
            x = IF._dropout(x, self.act_dropout_rate)
        x = torch.matmul(x, self.linear2_weight) + self.linear2_bias
        if self.dropout_rate and self.training:
            x = IF._dropout(x, self.dropout_rate)
        x = x + residual
        if not self.normalize_before:
            x = IF._first(IF.fused_layer_norm(
                x, self.ln2_scale, self.ln2_bias, epsilon=self.epsilon))
        return x


class FusedTransformerEncoderLayer(_Fused):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32, seed=0, kw=None):
        super().__init__(_options(device, dtype, seed, kw))
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate
            if attn_dropout_rate is not None else dropout_rate,
            normalize_before=normalize_before, kw=self._kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, kw=self._kw)

    def forward(self, src, src_mask=None, cache=None):
        out = self.fused_attn(src, attn_mask=src_mask)
        return self.ffn(out)


class FusedMultiTransformer(_Fused):
    """N fused pre-LN layers with one shared forward (the reference's
    inference-serving block): self-attention (``is_causal=False``, as in
    JAX) + FFN.  `caches`, `seq_lens` and `time_step` are ignored, as
    the JAX layer ignores them."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None, epsilon=1e-5,
                 num_layers=-1, nranks=1, trans_qkvw=True, ring_id=-1,
                 name=None, *, device=None, dtype=torch.float32, seed=0,
                 kw=None):
        super().__init__(_options(device, dtype, seed, kw))
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN (reference "
                             "contract)")
        if num_layers < 0:
            num_layers = 1
        self.layers = nn.ModuleList()
        for _ in range(num_layers):
            blk = nn.Sequential()
            blk.attn = FusedMultiHeadAttention(
                embed_dim, num_heads, dropout_rate=dropout_rate,
                attn_dropout_rate=dropout_rate, normalize_before=True,
                epsilon=epsilon, kw=self._kw)
            blk.ffn = FusedFeedForward(
                embed_dim, dim_feedforward, dropout_rate=dropout_rate,
                activation=activation, normalize_before=True,
                epsilon=epsilon, kw=self._kw)
            self.layers.append(blk)

    def forward(self, src, attn_mask=None, caches=None, seq_lens=None,
                time_step=None):
        x = src
        for blk in self.layers:
            x = blk.attn(x, attn_mask=attn_mask)
            x = blk.ffn(x)
        return x


class FusedEcMoe(_Fused):
    """Expert-choice MoE block (JAX :270): a gate `Linear(hidden,
    num_experts)` ([in, out], as every `Linear` of the port), then each
    expert's two-layer FFN batched over experts with einsums, weighted by
    the softmax of the gate.  Parameters `e_w1` [E, H, I], `e_b1` [E, 1,
    I], `e_w2` [E, I, H], `e_b2` [E, 1, H]; the biases are added per
    expert (``b[:, None]``).  gelu is the tanh form; an `act_type` other
    than gelu / relu raises ValueError."""

    def __init__(self, hidden_size, inter_size, num_experts, act_type="gelu",
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32, seed=0, kw=None):
        super().__init__(_options(device, dtype, seed, kw))
        if act_type not in ("gelu", "relu"):
            raise ValueError(f"unsupported act_type {act_type}")
        self.act_type = act_type
        kw = self._kw
        self.gate = Linear(hidden_size, num_experts, device=kw["device"],
                           dtype=kw["dtype"], generator=kw["generator"])
        self.e_w1 = self.param([num_experts, hidden_size, inter_size])
        self.e_b1 = self.param([num_experts, 1, inter_size], is_bias=True)
        self.e_w2 = self.param([num_experts, inter_size, hidden_size])
        self.e_b2 = self.param([num_experts, 1, hidden_size], is_bias=True)

    def forward(self, x, gate=None):
        gate_logits = self.gate(x) if gate is None else gate
        return IF._moe(x, gate_logits, self.e_w1, self.e_b1[:, None],
                       self.e_w2, self.e_b2[:, None], self.act_type,
                       "FusedEcMoe")
