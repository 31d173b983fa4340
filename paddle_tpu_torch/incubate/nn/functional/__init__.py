"""incubate.nn.functional counterpart (``paddle_tpu/incubate/nn/
functional/__init__.py``): the fused norms, linears, dropout-add and the
fused transformer functionals, each with the JAX function's conditions
copied literally.

`fused_rms_norm` / `fused_layer_norm` run `FusedNorm` (the `fused_norm`
kernel on CUDA, its plain version on the CPU; the backward plain, as the
JAX VJP's jnp backward).  Attention runs the port's
`scaled_dot_product_attention` (the flash kernels on CUDA); the large
matmuls are `torch.matmul`, as the JAX package leaves them to XLA.
Dropout is the port's `nn.functional.dropout`; the attention dropout
rate reaches the attention call, which applies it to nothing (ROADMAP
C2.6).

Not ported yet (ROADMAP Queue A): `masked_multihead_attention`,
`block_multihead_attention`, `variable_length_memory_efficient_attention`,
`fused_ec_moe`, `fused_bias_act` and `swiglu`.
"""
from __future__ import annotations

import torch

from ....nn import functional as F
from ....ops.kernels.fused_norm import FusedNorm

__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_linear",
    "fused_linear_activation", "fused_matmul_bias", "fused_dropout_add",
    "fused_multi_head_attention", "fused_feedforward",
    "fused_multi_transformer", "fused_bias_dropout_residual_layer_norm",
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
