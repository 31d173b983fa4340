"""relu, relu6, gelu and swiglu (``paddle_tpu/nn/functional/
activation.py:22``, ``:31``, ``:66`` and ``:168`` counterparts)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0, 6)


def gelu(x, approximate=False):
    """`approximate=True` is the tanh form (jax.nn.gelu's), the one GPT
    uses; the default is the erf form (Swin's `nn.GELU()`)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def swiglu(x, y=None):
    """silu(x) * y, over the two halves of x's last axis when y is not
    given (LLaMA's fused gate_up projection)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return x * torch.sigmoid(x) * y
