"""Layers of the port (``paddle_tpu/nn`` counterpart): the inference
subset the GPT serving path uses."""
from __future__ import annotations

from . import functional  # noqa: F401
from .layers_common import Dropout, Embedding, LayerNorm, Linear  # noqa: F401
