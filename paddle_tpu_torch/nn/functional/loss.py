"""cross_entropy (``paddle_tpu/nn/functional/loss.py:29`` counterpart)."""
from __future__ import annotations

import torch


def cross_entropy(input, label, ignore_index=-100):
    """Hard-label cross entropy over the last axis, mean over the tokens
    whose label is not `ignore_index` (their count clamped at 1e-12, as
    the JAX package does): log-softmax in the input's dtype, the
    target's log-probability picked.  The other reductions, soft labels,
    class weights and label smoothing are not ported."""
    logp = torch.log_softmax(input, dim=-1)
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    loss = torch.where(valid, -logp.gather(-1, safe[..., None])[..., 0],
                       0.0)
    return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1e-12)
