"""MobileNetV2 (``paddle_tpu/vision/models/mobilenetv2.py``
counterpart).

`ConvBNReLU` runs through `conv_bn_act` with relu6: in eval mode the
fused kernel, dense for the stem, the expansions and the last 1x1 conv,
depthwise for the 3x3 convs (35 launches per forward, 17 of them
depthwise).  The projection conv and its batch norm are plain ops, as
in the JAX package.  Names and shapes equal the JAX model's
``functional_state()`` (``features.3.conv.1.0.weight``).
"""
from __future__ import annotations

import torch

from ... import nn
from ...core.device import resolve_device
from ...nn.layer_base import Layer
from ._fused import conv_bn_act


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, *, kw):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride, padding=(kernel - 1) // 2,
                      groups=groups, bias_attr=False, **kw),
            nn.BatchNorm2D(out_c, device=kw["device"], dtype=kw["dtype"]),
            nn.ReLU6())

    def forward(self, x):
        return conv_bn_act(x, self[0], self[1], "relu6")


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, *, kw):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1, kw=kw))
        layers.extend([
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden, kw=kw),
            nn.Conv2D(hidden, oup, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(oup, device=kw["device"], dtype=kw["dtype"]),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(Layer):
    """Built in eval mode on `device` (``None`` = CUDA), parameters drawn
    from a generator seeded with `seed`."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [
            [1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
            [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1],
        ]
        input_channel = _make_divisible(32 * scale)
        last_channel = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, kw=kw)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, kw=kw))
                input_channel = out_c
        features.append(ConvBNReLU(input_channel, last_channel, kernel=1,
                                   kw=kw))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes, **kw))
        self.last_channel = last_channel
        self.eval()

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)
