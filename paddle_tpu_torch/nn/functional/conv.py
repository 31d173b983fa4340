"""Convolutions (``paddle_tpu/nn/functional/conv.py`` counterpart):
conv1d / conv2d / conv3d and the three transposed convolutions, with
Paddle's weight layouts (``[Cout, Cin / groups, *k]``; transposed
``[Cin, Cout / groups, *k]``), channel-first or channel-last
`data_format`, int / per-axis / per-side / string ("SAME", "VALID")
padding, `dilation` and `groups`.

The JAX package runs these through `lax.conv_general_dilated` outside
any Pallas kernel; the port leaves them to `torch.nn.functional`'s
convolutions in the same way.  Asymmetric and "SAME" padding pad the
input first (XLA's SAME: the total pad split with the odd element
after).  A transposed convolution is the JAX formula: a stride-dilated
input padded by dilation * (k - 1) - pad on each side (plus
`output_padding` after), convolved with the flipped, transposed kernel.
`output_size` is accepted and unused, as in JAX.  The conv inside
`conv_bn_act` is the port's own kernel (``ops/kernels/conv_norm.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import gate as _amp

__all__ = [
    "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v if len(v) == n else tuple(v[i % len(v)] for i in range(n))


def _pad_pairs(padding, n):
    """[(before, after)] per spatial axis of an int, n ints, 2n ints
    (before, after per axis) or n pairs; a string is returned as is."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(int(q) for q in p) for p in padding]


def _same_pairs(spatial, k, stride, dil):
    """XLA's SAME padding: output ceil(in / stride), the total pad split
    with the extra element after."""
    out = []
    for size, kk, s, d in zip(spatial, k, stride, dil):
        eff = d * (kk - 1) + 1
        total = max(0, ((size + s - 1) // s - 1) * s + eff - size)
        out.append((total // 2, total - total // 2))
    return out


def _to_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _to_last(x, channel_last):
    return x.movedim(1, -1) if channel_last else x


def _flat_pad(pairs):
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          channel_last, op):
    x, weight, bias = _amp.cast(op, x, weight, bias)
    x = _to_first(x, channel_last)
    stride, dil = _tup(stride, n), _tup(dilation, n)
    pairs = _pad_pairs(padding, n)
    if pairs == "VALID":
        pairs = [(0, 0)] * n
    elif pairs == "SAME":
        pairs = _same_pairs(x.shape[2:], weight.shape[2:], stride, dil)
    if all(lo == hi for lo, hi in pairs):
        sym = tuple(lo for lo, _ in pairs)
    else:
        x = F.pad(x, _flat_pad(pairs))
        sym = (0,) * n
    out = _CONV[n](x, weight, bias, stride, sym, dil, groups)
    return _amp.seen(op, _to_last(out, channel_last))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format == "NLC", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """x [B, Cin, H, W] (NHWC with ``data_format="NHWC"``), weight
    [Cout, Cin / groups, kh, kw].  In the AMP dtype under
    `amp.auto_cast`."""
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format == "NHWC", "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format == "NDHWC", "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, channel_last, op):
    """JAX `_conv_transpose` (:108): a stride-dilated input, padded by
    dilation * (k - 1) - pad before and that + output_padding after,
    convolved with the spatially flipped kernel, its in / out axes
    swapped per group."""
    x, weight, bias = _amp.cast(op, x, weight, bias)
    x = _to_first(x, channel_last)
    strides, dil = _tup(stride, n), _tup(dilation, n)
    opad = _tup(output_padding, n)
    k = weight.shape[2:]
    pairs = _pad_pairs(padding, n)
    if isinstance(pairs, str):
        # lax's string padding applies to the dilated input as it stands
        dilated = [(s - 1) * (size - 1) + size
                   for s, size in zip(strides, x.shape[2:])]
        pairs = ([(0, 0)] * n if pairs == "VALID"
                 else _same_pairs(dilated, k, (1,) * n, dil))
        pad_cfg = pairs
    else:
        pad_cfg = [(dil[i] * (k[i] - 1) - pairs[i][0],
                    dil[i] * (k[i] - 1) - pairs[i][1] + opad[i])
                   for i in range(n)]
    w = torch.flip(weight, dims=tuple(range(2, 2 + n)))
    ci, co_g = w.shape[0], w.shape[1]
    w = w.reshape((groups, ci // groups) + tuple(w.shape[1:]))
    w = w.transpose(1, 2).reshape((groups * co_g, ci // groups) + tuple(k))
    if any(s > 1 for s in strides):
        b, c = x.shape[:2]
        shape = [b, c] + [(size - 1) * s + 1
                          for size, s in zip(x.shape[2:], strides)]
        up = x.new_zeros(shape)
        up[(slice(None), slice(None))
           + tuple(slice(None, None, s) for s in strides)] = x
        x = up
    lo = [max(0, p[0]) for p in pad_cfg]
    hi = [max(0, p[1]) for p in pad_cfg]
    x = F.pad(x, _flat_pad(list(zip(lo, hi))))
    # negative pads crop
    crop = tuple(slice(max(0, -p[0]), x.shape[2 + i] - max(0, -p[1]))
                 for i, p in enumerate(pad_cfg))
    x = x[(slice(None), slice(None)) + crop]
    out = _CONV[n](x, w, bias, 1, 0, dil, groups)
    return _amp.seen(op, _to_last(out, channel_last))


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format == "NLC",
                           "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format == "NHWC",
                           "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format == "NDHWC",
                           "conv3d_transpose")
