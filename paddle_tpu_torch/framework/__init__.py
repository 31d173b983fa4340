"""``paddle_tpu/framework`` counterpart: `io_utils`, the `save` / `load`
of state dicts in the JAX package's file format."""
from __future__ import annotations

from .io_utils import load, save  # noqa: F401

__all__ = ["load", "save"]
