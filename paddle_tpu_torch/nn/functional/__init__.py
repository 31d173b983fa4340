"""Functionals of the port (``paddle_tpu/nn/functional`` counterpart)."""
from __future__ import annotations

from .activation import gelu  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
