"""matmul (``paddle_tpu/ops/linalg.py:27`` counterpart), the JAX op
"matmul": white-listed under `amp.auto_cast`, which casts both operands
to the AMP dtype."""
from __future__ import annotations

import torch

from ..amp import gate as _amp


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y, each optionally transposed over its last two axes (a 1-D
    operand is not transposed)."""
    x, y = _amp.cast("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return _amp.seen("matmul", torch.matmul(x, y))
