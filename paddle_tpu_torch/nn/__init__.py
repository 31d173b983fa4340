"""Layers of the port (``paddle_tpu/nn`` counterpart): the subset the
GPT and LLaMA serving and training paths use."""
from __future__ import annotations

from . import functional  # noqa: F401
from .layers_common import (  # noqa: F401
    Dropout, Embedding, LayerNorm, Linear, RMSNorm,
)
