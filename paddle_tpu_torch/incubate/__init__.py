"""paddle.incubate counterpart (``paddle_tpu/incubate/__init__.py``):
`incubate.nn` (the fused blocks, `FusedEcMoe` and the decode-step
functionals), `incubate.optimizer` (`LookAhead`, `ModelAverage`,
`DistributedFusedLamb`), `incubate.asp` (n:m structured sparsity) and
the fused masked softmaxes.

Not ported yet: the MoE layer (`incubate.distributed.models.moe`, which
needs `global_scatter`: ROADMAP A7), the graph aliases and
`graph_khop_sampler` (they need `geometric`), `identity_loss` (the
top-level op) and `incubate.autograd` (it needs `autograd.functional`),
all three under A9.
"""
from __future__ import annotations

import torch

from . import asp  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last axis in f32, cast to x's dtype
    (JAX :51, one XLA fusion there: plain torch here on both devices)."""
    return torch.softmax(x.float() + mask.float(), dim=-1).to(x.dtype)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax over the last axis: entries above the diagonal get
    -1e30, softmax in f32, cast to x's dtype (JAX :66)."""
    s = x.shape[-1]
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(keep, x.float(), -1e30),
                         dim=-1).to(x.dtype)
