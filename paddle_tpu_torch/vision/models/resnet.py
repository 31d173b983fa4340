"""ResNet family (``paddle_tpu/vision/models/resnet.py`` counterpart).

Every ``act(bn(conv(x)))`` of the stem and the blocks goes through
`conv_bn_act`: in eval mode the fused kernel (49 launches per ResNet-50
forward), otherwise the composed ops.  The downsample projection is a
plain conv and batch norm, as in the JAX package, and the grouped 3x3
convs of the ResNeXt presets take the composed path (the kernel is dense
or depthwise).  Names and shapes equal the JAX model's
``functional_state()``.  Models are built in eval mode on `device`
(``None`` = CUDA), parameters drawn from a generator seeded with `seed`.
In training mode batch norm takes batch statistics, which `_fusable`
refuses to fold, so every conv takes the composed route (no
`conv_bn_act` launch), as in the JAX package.
"""
from __future__ import annotations

import torch

from ... import nn
from ...core.device import resolve_device
from ...nn.layer_base import Layer
from ._fused import conv_bn_act


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, *, kw):
        super().__init__()
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(planes, **nkw)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **kw)
        self.bn2 = nn.BatchNorm2D(planes, **nkw)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = conv_bn_act(x, self.conv1, self.bn1, "relu")
        out = conv_bn_act(out, self.conv2, self.bn2, None)
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, *, kw):
        super().__init__()
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(width, **nkw)
        self.conv2 = nn.Conv2D(width, width, 3, padding=1, stride=stride,
                               groups=groups, bias_attr=False, **kw)
        self.bn2 = nn.BatchNorm2D(width, **nkw)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, **kw)
        self.bn3 = nn.BatchNorm2D(planes * self.expansion, **nkw)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = conv_bn_act(x, self.conv1, self.bn1, "relu")
        out = conv_bn_act(out, self.conv2, self.bn2, "relu")
        out = conv_bn_act(out, self.conv3, self.bn3, None)
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=gen)
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(self.inplanes, device=dev, dtype=dtype)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, kw)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, kw)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, kw)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, kw)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **kw)
        self.eval()

    def _make_layer(self, block, planes, blocks, stride, kw):
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **kw),
                nn.BatchNorm2D(planes * block.expansion, **nkw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, kw=kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, kw=kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = conv_bn_act(x, self.conv1, self.bn1, "relu")
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def resnet18(**kw):
    return ResNet(BasicBlock, 18, **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, 34, **kw)


def resnet50(**kw):
    return ResNet(BottleneckBlock, 50, **kw)


def resnet101(**kw):
    return ResNet(BottleneckBlock, 101, **kw)


def resnet152(**kw):
    return ResNet(BottleneckBlock, 152, **kw)


def resnext50_32x4d(**kw):
    return ResNet(BottleneckBlock, 50, groups=32, width=4, **kw)


def resnext50_64x4d(**kw):
    return ResNet(BottleneckBlock, 50, groups=64, width=4, **kw)


def resnext101_32x4d(**kw):
    return ResNet(BottleneckBlock, 101, groups=32, width=4, **kw)


def resnext101_64x4d(**kw):
    return ResNet(BottleneckBlock, 101, groups=64, width=4, **kw)


def resnext152_32x4d(**kw):
    return ResNet(BottleneckBlock, 152, groups=32, width=4, **kw)


def resnext152_64x4d(**kw):
    return ResNet(BottleneckBlock, 152, groups=64, width=4, **kw)


def wide_resnet50_2(**kw):
    return ResNet(BottleneckBlock, 50, width=64 * 2, **kw)


def wide_resnet101_2(**kw):
    return ResNet(BottleneckBlock, 101, width=64 * 2, **kw)
