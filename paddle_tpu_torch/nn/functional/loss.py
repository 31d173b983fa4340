"""Loss functionals (``paddle_tpu/nn/functional/loss.py`` counterpart):
cross_entropy and softmax_with_cross_entropy (:28, :73), and the rest of
the module's losses below them, each the JAX formula with Paddle's
`reduction`, `weight` and `ignore_index`.  `ctc_loss` and `rnnt_loss`
keep JAX's log-space lattice recursions (its blank and `norm_by_times`
handling), run as loops over time here, not cuDNN's CTC.

cross_entropy has every option of the JAX function:

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

import math
import warnings

import torch
import torch.nn.functional as F

from ...amp import gate as _amp

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss", "square_error_cost",
    "sigmoid_focal_loss", "hinge_embedding_loss", "cosine_embedding_loss",
    "triplet_margin_loss", "log_loss", "npair_loss", "poisson_nll_loss",
    "multi_label_soft_margin_loss", "soft_margin_loss", "ctc_loss",
    "margin_cross_entropy", "rnnt_loss", "dice_loss", "hsigmoid_loss",
    "triplet_margin_with_distance_loss", "multi_margin_loss",
    "gaussian_nll_loss",
]


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


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = _amp.cast("mse_loss", input, label)
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = _amp.cast("l1_loss", input, label)
    return _reduce(torch.abs(input - label), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """-input[n, label[n]] over class axis 1; `ignore_index` rows give 0
    and leave the mean's denominator (the valid rows' weights)."""
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, _zero(loss))
    if reduction == "mean":
        denom = (weight[safe] * valid).sum() if weight is not None \
            else valid.sum()
        return loss.sum() / torch.clamp(denom, min=1e-12)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    max_val = torch.clamp(-logit, min=0)
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (
            torch.log1p(torch.exp(-torch.abs(logit))) + max_val)
    else:
        loss = (1 - label) * logit + max_val + torch.log(
            torch.exp(-max_val) + torch.exp(-logit - max_val))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        out = label * (torch.log(torch.clamp(label, min=1e-30)) - input)
        loss = torch.where(label > 0, out, _zero(out))
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0),
                   reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = (1 - label) * logit + torch.clamp(-logit, min=0) \
        + torch.log(torch.exp(-torch.abs(logit)) + 1)
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1.0, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = torch.sum(input1 * input2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.pow(torch.sum(torch.abs(a - b) ** p, dim=-1) + epsilon,
                         1.0 / p)

    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), 1))
                    + torch.mean(torch.sum(torch.square(positive), 1))) / 4
    sim = anchor @ positive.T
    lab = (labels.reshape(-1, 1) == labels.reshape(1, -1)).to(sim.dtype)
    lab = lab / lab.sum(dim=1, keepdim=True)
    ce = -torch.mean(torch.sum(lab * torch.log_softmax(sim, dim=1), dim=1))
    return ce + reg


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label + epsilon) - label \
            + 0.5 * torch.log(2 * math.pi * (label + epsilon))
        loss = loss + torch.where(label > 1, stirling, _zero(stirling))
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    loss = -(label * F.logsigmoid(input)
             + (1 - label) * F.logsigmoid(-input))
    loss = loss.mean(dim=-1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def _logaddexp3(a1, a2, a3):
    m = torch.maximum(torch.maximum(a1, a2), a3)
    return m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)
                         + torch.exp(a3 - m))


def _shift(a, k, fill):
    """a [B, S] shifted right by k along S, `fill` in front."""
    return torch.cat([a.new_full((a.shape[0], k), fill), a[:, :-k]], dim=1)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC (JAX :336): the alpha recursion over the blank-interleaved
    [B, 2L + 1] lattice in log space, f32, from log_probs [T, B, C] and
    padded labels [B, L]; rows past a sample's input length keep their
    alphas.  ``norm_by_times`` divides each loss by its input length;
    "mean" averages loss / label length."""
    t_max, b, _ = log_probs.shape
    l_max = labels.shape[1]
    s_max = 2 * l_max + 1
    neg = -1e30
    lp = log_probs.float()
    dev = lp.device
    ext = torch.full((b, s_max), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    prev2 = torch.cat([ext.new_full((b, 2), -1), ext[:, :-2]], dim=1)
    allow_skip = (ext != blank) & (ext != prev2)
    in_len = torch.as_tensor(input_lengths, device=dev).long().reshape(b)
    lab_len = torch.as_tensor(label_lengths, device=dev).long().reshape(b)
    pos = torch.arange(s_max, device=dev)[None, :]
    negt = torch.full((), neg, device=dev)
    alpha = torch.gather(lp[0], 1, ext)
    alpha = torch.where(pos < 2, alpha, negt)
    alpha = torch.where((pos == 1) & (lab_len[:, None] == 0), negt, alpha)
    for t in range(1, t_max):
        a3 = torch.where(allow_skip, _shift(alpha, 2, neg), negt)
        new = _logaddexp3(alpha, _shift(alpha, 1, neg), a3) \
            + torch.gather(lp[t], 1, ext)
        alpha = torch.where(t < in_len[:, None], new, alpha)
    last = 2 * lab_len
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, (last - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, negt)
    m = torch.maximum(a_last, a_prev)
    loss = -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))
    if norm_by_times:
        loss = loss / in_len.clamp(min=1).to(loss.dtype)
    if reduction == "mean":
        return torch.mean(loss / lab_len.clamp(min=1).to(loss.dtype))
    if reduction == "sum":
        return loss.sum()
    return loss


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax CE (JAX :428): the target class's
    cosine becomes cos(m1 theta + m2) - m3 before the scale."""
    if group is not None:
        raise NotImplementedError(
            "margin_cross_entropy: explicit process groups are not used; "
            "the class axis is one device's")
    lb = label.reshape(-1).long()
    c = logits.shape[1]
    onehot = F.one_hot(lb, c).to(logits.dtype)
    theta = torch.arccos(torch.clamp(logits, -1.0 + 1e-7, 1.0 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    mod = torch.where(onehot > 0, target, logits) * scale
    logp = torch.log_softmax(mod, dim=-1)
    loss = -torch.sum(onehot * logp, dim=-1, keepdim=True)
    out = _reduce(loss, reduction)
    return (out, torch.exp(logp)) if return_softmax else out


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss (JAX :470): the (T, U) lattice's forward
    recursion in log space, f32, over joint logits [B, T, U + 1, V] and
    padded labels [B, U].  FastEmit is not applied, with JAX's warning
    for a non-zero `fastemit_lambda`."""
    if fastemit_lambda:
        warnings.warn(
            "rnnt_loss: fastemit_lambda regularization is not applied in "
            "this build (plain RNNT objective); pass fastemit_lambda=0 "
            "to silence", stacklevel=2)
    b, t_max, u1, _ = input.shape
    u_max = u1 - 1
    dev = input.device
    negt = torch.full((), -1e30, device=dev)
    logp = torch.log_softmax(input.float(), dim=-1)
    blank_lp = logp[..., blank]                               # [B, T, U+1]
    in_len = torch.as_tensor(input_lengths, device=dev).long().reshape(b)
    lab_len = torch.as_tensor(label_lengths, device=dev).long().reshape(b)
    emit = torch.gather(logp[:, :, :u_max, :], -1, label.long()[
        :, None, :, None].expand(b, t_max, u_max, 1))[..., 0]
    upos = torch.arange(u_max, device=dev)[None, None, :]
    emit = torch.where(upos < lab_len.reshape(b, 1, 1), emit, negt)
    row = torch.cat([torch.zeros(b, 1, device=dev),
                     torch.cumsum(emit[:, 0, :], dim=-1)], dim=-1)
    for t in range(1, t_max):
        top = row + blank_lp[:, t - 1]
        cols = [top[:, 0]]
        for u in range(1, u1):
            a, e = top[:, u], cols[-1] + emit[:, t, u - 1]
            m = torch.maximum(a, e)
            cols.append(m + torch.log(torch.exp(a - m) + torch.exp(e - m)))
        new = torch.stack(cols, dim=-1)
        row = torch.where(t < in_len[:, None], new, row)
    final_alpha = torch.gather(row, 1, lab_len[:, None])[:, 0]
    tb = (in_len - 1).clamp(min=0)
    final_blank = blank_lp[torch.arange(b, device=dev), tb, lab_len]
    loss = -(final_alpha + final_blank)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - dice coefficient per sample, averaged: input [N, ..., C]
    probabilities, label [N, ..., 1] class ids."""
    c = input.shape[-1]
    y1 = F.one_hot(label.reshape(label.shape[:-1]).long(), c).to(input.dtype)
    fx, fy = input.reshape(input.shape[0], -1), y1.reshape(y1.shape[0], -1)
    inter = torch.sum(fx * fy, dim=1)
    union = torch.sum(fx, dim=1) + torch.sum(fy, dim=1)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


def _hsigmoid_paths(num_classes, device):
    """Each class's root-to-leaf path over the default complete binary
    tree (heap order): (internal node ids, codes, validity), padded."""
    depth = max(1, int(math.ceil(math.log2(max(num_classes, 2)))))
    tables, codes, masks = [], [], []
    for cls in range(num_classes):
        node, path = cls + num_classes, []
        while node > 1:
            path.append((node // 2 - 1, node % 2))
            node //= 2
        path = path[::-1]
        pad = depth - len(path)
        tables.append([p[0] for p in path] + [0] * pad)
        codes.append([p[1] for p in path] + [0] * pad)
        masks.append([1.0] * len(path) + [0.0] * pad)
    return (torch.tensor(tables, dtype=torch.long, device=device),
            torch.tensor(codes, dtype=torch.float32, device=device),
            torch.tensor(masks, dtype=torch.float32, device=device))


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree (JAX
    :547): the mean over samples of the summed binary cross entropies
    along the sample's class path, in f32."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom-tree hsigmoid (path_table/path_code) is not wired; "
            "the default complete-binary-tree path is supported")
    t, c, m = _hsigmoid_paths(num_classes, input.device)
    yy = label.reshape(-1).long()
    nodes, code, mask = t[yy], c[yy], m[yy]
    logit = torch.einsum("nd,nkd->nk", input.float(), weight[nodes].float())
    if bias is not None:
        logit = logit + bias.reshape(-1)[nodes]
    per = torch.clamp(logit, min=0) - logit * code \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    return torch.mean(torch.sum(per * mask, dim=1))


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        def distance_function(a, b):
            return torch.sqrt(torch.sum(torch.square(torch.abs(a - b)),
                                        dim=-1))
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, distance_function(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """Hinge loss of each class's score against the true class's, the
    true class left out, averaged over the classes."""
    n, c = input.shape
    yy = label.reshape(-1).long()
    true = torch.gather(input, 1, yy[:, None])
    m = torch.clamp(margin - true + input, min=0.0) ** p
    if weight is not None:
        m = m * weight.reshape(-1)[yy][:, None]
    m = m * (1 - F.one_hot(yy, c).to(input.dtype))
    return _reduce(torch.sum(m, dim=1) / c, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    v = torch.clamp(variance.float(), min=epsilon)
    out = 0.5 * (torch.log(v) + (label.float() - input.float()) ** 2 / v)
    if full:
        out = out + 0.5 * math.log(2 * math.pi)
    return _reduce(out, reduction)
