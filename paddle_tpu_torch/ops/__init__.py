"""Operators of the port (``paddle_tpu/ops`` counterpart)."""
from __future__ import annotations

from .linalg import matmul  # noqa: F401
