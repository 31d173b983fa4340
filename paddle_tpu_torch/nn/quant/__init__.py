"""paddle.nn.quant (``paddle_tpu/nn/quant/__init__.py`` counterpart):
the weight-only and LLM.int8 quantized linear path.

The JAX layout: the quantized weight is stored transposed, [out, in]
int8 (int4 packs two signed nibbles a byte along `in`, `_pack_int4`
:38); the per-channel scale is [out] f32, the grouped one [ceil(in / g),
out].  The compute is dequantize-then-matmul, as in JAX (a W8A16 kernel
is ROADMAP A4.6).  `llm_int8_linear`'s int8 x int8 product accumulates
exactly (in f64, whose 53-bit mantissa holds every int32 sum of int8
products at these widths) on every device.
"""
from __future__ import annotations

import torch

from ...core.device import resolve_device
from ...core.dtypes import convert_dtype
from ..layer_base import Layer, Parameter

__all__ = ["Stub", "weight_quantize", "weight_dequantize",
           "weight_only_linear", "llm_int8_linear", "WeightOnlyLinear"]

_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")


def _check(algo, group_size):
    if algo not in _ALGOS:
        raise ValueError(f"algo must be one of {_ALGOS}, got {algo!r}")
    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1/64/128, got {group_size}")


def _pack_int4(q):
    """q: int8 in [-8, 7], [out, in] -> [out, in // 2], two nibbles a
    byte (the even column low).  `in` must be even."""
    if q.shape[1] % 2 != 0:
        raise ValueError(
            f"weight_only_int4 requires even in_features, got {q.shape[1]}")
    lo = q[:, 0::2].to(torch.int32) & 0x0F
    hi = (q[:, 1::2].to(torch.int32) & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def _unpack_int4(p):
    p32 = p.to(torch.int32)
    lo = ((p32 & 0x0F) ^ 8) - 8                     # sign-extend a nibble
    hi = (((p32 >> 4) & 0x0F) ^ 8) - 8
    return torch.stack([lo, hi], -1).reshape(p.shape[0], -1).to(torch.int8)


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """x: [in, out] float weights.  Returns (the [out, in] int8 codes,
    int4 packed to [out, in // 2], and the f32 scale: [out] per channel,
    [ceil(in / group), out] grouped)."""
    _check(algo, group_size)
    w = x.to(torch.float32)
    n_in, n_out = w.shape
    # a device tensor, not a Python number: CUDA divides by a host
    # scalar as a multiply by its reciprocal, which rounds otherwise
    qmax = torch.tensor(7.0 if algo == "weight_only_int4" else 127.0,
                        device=w.device)
    if group_size == -1:
        scale = torch.amax(torch.abs(w), 0) / qmax                  # [out]
        q = torch.round(w / torch.clamp(scale, min=1e-10)[None, :])
    else:
        g = -(-n_in // group_size)
        wg = torch.nn.functional.pad(w, (0, 0, 0, g * group_size - n_in))
        wg = wg.reshape(g, group_size, n_out)
        scale = torch.amax(torch.abs(wg), 1) / qmax                 # [g, out]
        q = torch.round(wg / torch.clamp(scale, min=1e-10)[:, None, :])
        q = q.reshape(g * group_size, n_out)[:n_in]
    q = torch.clamp(q, -qmax - 1, qmax).to(torch.int8).T.contiguous()
    if algo == "weight_only_int4":
        q = _pack_int4(q)
    return q, scale.to(torch.float32)


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float32",
                      group_size=-1):
    """The inverse of `weight_quantize`: [in, out] floats."""
    _check(algo, group_size)
    q = _unpack_int4(x) if algo == "weight_only_int4" else x
    w = q.to(torch.float32).T                                      # [in, out]
    scale = scale.to(torch.float32)
    if group_size == -1:
        w = w * scale[None, :]
    else:
        n_in, n_out = w.shape
        g = scale.shape[0]
        wp = torch.nn.functional.pad(w, (0, 0, 0, g * group_size - n_in))
        w = (wp.reshape(g, group_size, n_out) * scale[:, None, :]).reshape(
            g * group_size, n_out)[:n_in]
    return w.to(convert_dtype(out_dtype))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """x: [..., in]; weight: [out, in] int8 (or packed int4).  The
    weight dequantized to x's dtype, then x @ w (+ bias): [..., out]."""
    algo = "weight_only_int4" if weight_dtype == "int4" else \
        "weight_only_int8"
    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1/64/128, got {group_size}")
    w = weight_dequantize(weight, weight_scale, algo, x.dtype, group_size)
    y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0):
    """LLM.int8() (JAX :177): input channels whose absmax exceeds
    `threshold` stay in floating point; the rest are quantized per
    tensor to int8 and multiplied against the int8 weight with an exact
    integer sum; both products keep the full shape (a mask, no
    gather)."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), tuple(range(x32.dim() - 1)))
    outlier = absmax > threshold                                   # [in]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x_reg = torch.where(outlier, zero, x32)
    x_out = torch.where(outlier, x32, zero)
    a_scale = torch.clamp(torch.amax(torch.abs(x_reg)), min=1e-10) \
        / torch.tensor(127.0, device=x.device)
    xq = torch.clamp(torch.round(x_reg / a_scale), -128, 127).to(torch.int8)
    scale = weight_scale.to(torch.float32)
    y_reg = torch.matmul(xq.to(torch.float64), weight.to(torch.float64).T)
    y_reg = y_reg.to(torch.float32) * a_scale * scale[None, :]
    w_fp = weight.to(torch.float32) * scale[:, None]               # [out, in]
    y = y_reg + torch.matmul(x_out, w_fp.T)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


class WeightOnlyLinear(Layer):
    """A serving linear over pre-quantized weights; `from_linear` builds
    one from an `nn.Linear`."""

    def __init__(self, in_features, out_features, weight_dtype="int8",
                 group_size=-1, has_bias=True, *, device=None):
        super().__init__(device=device)
        self.weight_dtype = weight_dtype
        self.group_size = group_size
        if weight_dtype == "int4" and in_features % 2 != 0:
            raise ValueError(
                f"int4 WeightOnlyLinear requires even in_features, got "
                f"{in_features}")
        dev = resolve_device(device)
        packed_in = in_features // 2 if weight_dtype == "int4" \
            else in_features
        sshape = [out_features] if group_size == -1 else \
            [-(-in_features // group_size), out_features]
        self.quant_weight = Parameter(torch.zeros(
            out_features, packed_in, dtype=torch.int8, device=dev),
            requires_grad=False)
        self.weight_scale = Parameter(torch.ones(sshape, device=dev),
                                      requires_grad=False)
        self.bias = Parameter(torch.zeros(out_features, device=dev)) \
            if has_bias else None

    @classmethod
    def from_linear(cls, linear, weight_dtype="int8", group_size=-1):
        algo = "weight_only_int4" if weight_dtype == "int4" else \
            "weight_only_int8"
        w = linear.weight                                          # [in, out]
        in_f, out_f = w.shape
        q, scale = weight_quantize(w.detach(), algo=algo,
                                   group_size=group_size)
        layer = cls(in_f, out_f, weight_dtype, group_size,
                    has_bias=linear.bias is not None, device=w.device)
        with torch.no_grad():
            layer.quant_weight.copy_(q)
            layer.weight_scale.copy_(scale)
            if linear.bias is not None:
                layer.bias.copy_(linear.bias)
        return layer

    def forward(self, x):
        return weight_only_linear(
            x, self.quant_weight, self.bias, self.weight_scale,
            weight_dtype=self.weight_dtype, group_size=self.group_size)


class Stub(Layer):
    """A quantization insertion point for functional calls: identity
    until a quanter or observer is given (JAX :218)."""

    def __init__(self, observer=None):
        super().__init__()
        if observer is not None and hasattr(observer, "instance"):
            observer = observer.instance()
        self._observer = observer

    def forward(self, x):
        if self._observer is None:
            return x
        return self._observer(x)
