"""Optimizers of the port (``paddle_tpu/optimizer`` counterpart)."""
from __future__ import annotations

from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Momentum  # noqa: F401

__all__ = ["Adam", "AdamW", "Momentum", "lr"]
