"""cross_entropy (``paddle_tpu/nn/functional/loss.py:29`` counterpart)."""
from __future__ import annotations

import torch


def check_ported(weight=None, reduction="mean", soft_label=False, axis=-1,
                 use_softmax=True, label_smoothing=0.0):
    """Raise NotImplementedError for the options of `cross_entropy` the
    port does not have, rather than silently differ: class weights, a
    reduction other than the mean, soft labels, label smoothing, another
    axis than the last and ``use_softmax=False``."""
    unported = {"weight": weight is not None, "reduction": reduction != "mean",
                "soft_label": bool(soft_label), "axis": axis != -1,
                "use_softmax": not use_softmax,
                "label_smoothing": bool(label_smoothing)}
    for name, set_ in unported.items():
        if set_:
            raise NotImplementedError(
                f"cross_entropy({name}=...) is not ported yet (ROADMAP "
                "Queue A): the mean over hard labels on the last axis only")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Hard-label cross entropy over the last axis, mean over the tokens
    whose label is not `ignore_index` (their count clamped at 1e-12, as
    the JAX package does): log-softmax in the input's dtype, the
    target's log-probability picked.  The options `check_ported` names
    raise."""
    check_ported(weight, reduction, soft_label, axis, use_softmax,
                 label_smoothing)
    if label.is_floating_point():
        raise NotImplementedError(
            "cross_entropy with floating (soft) labels is not ported yet "
            "(ROADMAP Queue A); pass integer class ids")
    logp = torch.log_softmax(input, dim=-1)
    if label.dim() == input.dim() and label.shape[-1] == 1:
        # Paddle's [N, 1] label layout (JAX loss.py:50-51)
        label = label.squeeze(-1)
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    loss = torch.where(valid, -logp.gather(-1, safe[..., None])[..., 0],
                       0.0)
    return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1e-12)
