"""paddle.incubate counterpart (``paddle_tpu/incubate``): the fused
transformer blocks of `incubate.nn` and the fused functionals they run
on.  Only the names of this slice are ported; the rest of
``paddle_tpu/incubate`` (MoE, ASP, optimizers, the graph aliases) is not
(ROADMAP Queue A)."""
from __future__ import annotations

from . import nn  # noqa: F401
