"""Functionals of the port (``paddle_tpu/nn/functional`` counterpart):
every public function of the JAX package's modules, by the same names."""
from __future__ import annotations

from .activation import *  # noqa: F401,F403
from .attention import (  # noqa: F401
    apply_rotary_pos_emb, flash_attention, flash_attn_unpadded,
    fused_rotary_position_embedding, rotary_phases, rotate_qk,
    scaled_dot_product_attention, sdp_kernel,
)
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import (  # noqa: F401
    batch_norm, group_norm, instance_norm, layer_norm, local_response_norm,
    rms_norm,
)
from .pooling import *  # noqa: F401,F403
from .vision import *  # noqa: F401,F403
