"""Vision models of the port (``paddle_tpu/vision/models`` counterpart):
ResNet (and ResNeXt, wide ResNet), MobileNetV2, Swin and ViT, for
inference and training.
VGG, LeNet and the ``extras.py`` families are not ported yet (ROADMAP
Queue A)."""
from __future__ import annotations

from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
    resnext152_32x4d, resnext152_64x4d, wide_resnet50_2, wide_resnet101_2,
)
from .swin import SwinTransformer, swin_b, swin_s, swin_t  # noqa: F401
from .vit import (  # noqa: F401
    VisionTransformer, vit_b_16, vit_b_32, vit_h_14, vit_l_16, vit_l_32,
)
