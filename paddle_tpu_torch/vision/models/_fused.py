"""The fused conv + batch-norm + activation of the vision models
(``paddle_tpu/vision/models/_fused.py`` counterpart).

`conv_bn_act(x, conv, bn, act)` computes ``act(bn(conv(x)))`` from the
modules themselves, so the models keep their parameter layout.  When
the JAX package's gate admits the pair (`_fusable`, :41-56: BN in eval
mode, relu / relu6 / none, int or pair stride and padding, dilation 1,
dense or depthwise groups) it folds the frozen statistics in f32 exactly
as JAX does (:78-88) and runs the `conv_bn_act` kernel through
`ConvBNAct`; otherwise the composed ops run.
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...ops.kernels.conv_norm import ConvBNAct

__all__ = ["conv_bn_act"]


def _int2(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(i) for i in v) if len(v) == 2 else None
    if isinstance(v, int):
        return (v, v)
    return None


def _fusable(conv, bn, act):
    if bn.training or conv.data_format != "NCHW":
        # the kernel takes NCHW only (JAX's gate does not ask)
        return False
    if act not in ("relu", "relu6", None):
        return False
    if _int2(conv.stride) is None or _int2(conv.padding) is None:
        return False
    if _int2(conv.dilation) != (1, 1):
        return False
    groups = conv.groups
    cin = conv.weight.shape[1] * groups
    cout = conv.weight.shape[0]
    return groups == 1 or (groups == cin and cout == cin)


def conv_bn_act(x, conv, bn, act="relu"):
    """x [B, Cin, H, W]; conv: `nn.Conv2D`; bn: `nn.BatchNorm2D`; act
    'relu', 'relu6' or None."""
    if not _fusable(conv, bn, act):
        out = bn(conv(x))
        if act == "relu":
            out = F.relu(out)
        elif act == "relu6":
            out = F.relu6(out)
        return out
    scale = torch.rsqrt(bn._variance.float() + bn.epsilon)
    if bn.weight is not None:
        scale = scale * bn.weight.float()
    shift = -bn._mean.float() * scale
    if bn.bias is not None:
        shift = shift + bn.bias.float()
    if conv.bias is not None:
        shift = shift + conv.bias.float() * scale
    return ConvBNAct.apply(x, conv.weight, scale, shift,
                           _int2(conv.stride), _int2(conv.padding), act)
