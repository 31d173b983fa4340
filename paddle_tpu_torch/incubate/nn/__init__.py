"""incubate.nn (``paddle_tpu/incubate/nn/__init__.py``): the fused
transformer layers, `FusedEcMoe` and their functionals."""
from __future__ import annotations

from . import functional  # noqa: F401
from .layers import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd, FusedEcMoe,
    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
    FusedMultiTransformer, FusedTransformerEncoderLayer,
)
