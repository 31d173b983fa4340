"""cross_entropy and softmax_with_cross_entropy
(``paddle_tpu/nn/functional/loss.py:28`` and ``:73`` counterparts), with
every option of the JAX function:

  * soft labels, recognised by ``soft_label=True`` or by a floating
    label with the input's shape along `axis` (:37-39): ``-sum(soft *
    logp)`` over `axis`; smoothing mixes the soft label with the
    uniform one (:41-42); a class `weight` multiplies each row by
    ``sum(soft * weight)`` (:43-46), and the mean is a plain mean;
  * hard labels (a trailing size-1 class axis squeezed, :50-51):
    ``-logp[label]``, with smoothing ``-(1 - e) logp[label] - e *
    mean(logp)`` (:56-58); `ignore_index` rows give 0; a weighted mean
    divides by the sum of the valid rows' weights, an unweighted one by
    their count, clamped at 1e-12 (:62-69);
  * ``use_softmax=False`` takes ``log(max(p, 1e-30))`` of the input
    (:35); ``reduction`` "mean", "sum" or "none"; any `axis`.

Log-softmax runs in the input's dtype, as in the JAX package; under
`amp.auto_cast` the op ("cross_entropy", black-listed) takes its input
and weight in f32.
"""
from __future__ import annotations

import torch

from ...amp import gate as _amp


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """The JAX function's loss (module docstring) of `input` against
    `label` along `axis`."""
    input, label, weight = _amp.cast("cross_entropy", input, label, weight)
    return _amp.seen("cross_entropy", _cross_entropy(
        input, label, weight, ignore_index, reduction, soft_label, axis,
        use_softmax, label_smoothing))


def _cross_entropy(logits, label, weight, ignore_index, reduction,
                   soft_label, axis, use_softmax, label_smoothing):
    axis = axis % logits.dim()
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, min=1e-30))
    n_classes = logits.shape[axis]
    if soft_label or (label.dim() == logits.dim()
                      and label.shape[axis] == n_classes
                      and label.is_floating_point()):
        soft = label
        if label_smoothing:
            soft = soft * (1 - label_smoothing) \
                + label_smoothing / n_classes
        loss = -torch.sum(soft * logp, dim=axis)
        if weight is not None:
            loss = loss * torch.sum(soft * weight, dim=axis)
        return _reduce(loss, reduction)
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        # Paddle's [N, 1] label layout
        label = label.squeeze(axis)
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing:
        loss = -(1 - label_smoothing) * picked \
            + label_smoothing * -logp.mean(dim=axis)
    else:
        loss = -picked
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, weight[safe], 0.0).sum()
        else:
            denom = valid.sum().to(loss.dtype)
        return loss.sum() / denom.clamp(min=1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced `cross_entropy`, its class axis kept (size 1); with
    `return_softmax` also the softmax of the logits ("softmax",
    black-listed under `amp.auto_cast`)."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.dim() < logits.dim():
        loss = loss.unsqueeze(axis)
    if return_softmax:
        (x,) = _amp.cast("softmax", logits)
        return loss, _amp.seen("softmax", torch.softmax(x, dim=axis))
    return loss
