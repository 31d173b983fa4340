"""Layers of the port (``paddle_tpu/nn`` counterpart): the subset the
GPT serving and training paths use."""
from __future__ import annotations

from . import functional  # noqa: F401
from .layers_common import Dropout, Embedding, LayerNorm, Linear  # noqa: F401
