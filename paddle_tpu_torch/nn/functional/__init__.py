"""Functionals of the port (``paddle_tpu/nn/functional`` counterpart)."""
from __future__ import annotations

from .activation import gelu, swiglu  # noqa: F401
from .attention import (  # noqa: F401
    apply_rotary_pos_emb, fused_rotary_position_embedding,
    scaled_dot_product_attention,
)
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm, rms_norm  # noqa: F401
