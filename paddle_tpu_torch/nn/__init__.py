"""Layers of the port (``paddle_tpu/nn`` counterpart): the subset the
GPT and LLaMA serving and training paths, the vision serving and
training paths and the encoder family (ERNIE, ViT) use, and gradient
clipping."""
from __future__ import annotations

from . import functional  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
    clip_grad_value_,
)
from .layers_activation import GELU, ReLU, ReLU6  # noqa: F401
from .layers_common import (  # noqa: F401
    Dropout, Dropout2D, Dropout3D, Embedding, LayerList, LayerNorm, Linear,
    RMSNorm, Sequential,
)
from .layers_conv_pool import (  # noqa: F401
    AdaptiveAvgPool2D, Conv2D, MaxPool2D,
)
from .layers_loss import CrossEntropyLoss  # noqa: F401
from .layers_norm import BatchNorm2D  # noqa: F401
from .layers_transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer,
)
