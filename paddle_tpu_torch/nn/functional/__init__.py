"""Functionals of the port (``paddle_tpu/nn/functional`` counterpart)."""
from __future__ import annotations

from .activation import gelu, relu, relu6, swiglu  # noqa: F401
from .attention import (  # noqa: F401
    apply_rotary_pos_emb, flash_attn_unpadded,
    fused_rotary_position_embedding, rotary_phases, rotate_qk,
    scaled_dot_product_attention,
)
from .common import (  # noqa: F401
    alpha_dropout, dropout, dropout2d, dropout3d,
)
from .conv import conv2d  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import batch_norm, layer_norm, rms_norm  # noqa: F401
from .pooling import adaptive_avg_pool2d, max_pool2d  # noqa: F401
