"""gelu (``paddle_tpu/nn/functional/activation.py:66`` counterpart)."""
from __future__ import annotations

import torch.nn.functional as F


def gelu(x, approximate=False):
    """`approximate=True` is the tanh form (jax.nn.gelu's), the one GPT
    uses."""
    return F.gelu(x, approximate="tanh" if approximate else "none")
