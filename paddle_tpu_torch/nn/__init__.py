"""Layers of the port (``paddle_tpu/nn`` counterpart): the subset the
GPT and LLaMA serving and training paths and the vision serving and
training paths use."""
from __future__ import annotations

from . import functional  # noqa: F401
from .layers_activation import GELU, ReLU, ReLU6  # noqa: F401
from .layers_common import (  # noqa: F401
    Dropout, Embedding, LayerList, LayerNorm, Linear, RMSNorm, Sequential,
)
from .layers_conv_pool import (  # noqa: F401
    AdaptiveAvgPool2D, Conv2D, MaxPool2D,
)
from .layers_loss import CrossEntropyLoss  # noqa: F401
from .layers_norm import BatchNorm2D  # noqa: F401
