"""Gradient clipping (``paddle_tpu/nn/clip.py`` counterpart):
`ClipGradByValue` :28, `ClipGradByNorm` :45, `ClipGradByGlobalNorm` :70,
`clip_grad_norm_` :107 and `clip_grad_value_` :133.

The classes map a list of ``(param, grad)`` pairs to a new list, leaving
out of the clip a pair whose gradient is None or whose parameter sets
``need_clip = False``.  Norms are taken in f32 and the scaled gradients
keep their dtype, with JAX's epsilons: 1e-12 under a single tensor's
norm, 1e-6 under the global norm.  Everything stays on the device: the
factors are tensors, and `clip_grad_norm_` scales by ``min(1, coef)``
where the JAX function reads the norm back to test ``coef < 1`` (the
same values, as the factor 1 leaves a gradient unchanged).
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient clipped elementwise to [min, max] (min = -max by
    default)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to L2 norm `clip_norm` where its norm is
    larger."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _scale(self, g):
        g32 = g.float()
        norm = g32.square().sum().sqrt()
        factor = torch.where(norm > self.clip_norm,
                             self.clip_norm / norm.clamp(min=1e-12), 1.0)
        return (g32 * factor).to(g.dtype)

    def _dygraph_clip(self, params_grads):
        return [(p, self._scale(g) if _clipped(p, g) else g)
                for p, g in params_grads]


def global_norm_sq(grads):
    """The sum of squares over `grads`, f32, on their device: the squares
    of the per-tensor norms of one multi-tensor launch (`_foreach_norm`),
    summed, where the JAX package sums each tensor's squares (the same
    value up to f32 rounding, in a few launches for any number of
    tensors)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.stack(norms).square().sum()


def global_norm_scale(gsq, clip_norm):
    """``min(clip_norm / max(sqrt(gsq), 1e-6), 1)``, a device tensor."""
    return (clip_norm / gsq.sqrt().clamp(min=1e-6)).clamp(max=1.0)


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by one factor, so that their joint
    L2 norm is at most `clip_norm`."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def _dygraph_clip(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        scale = global_norm_scale(global_norm_sq(grads), self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p, g)
                 else g) for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the `.grad` of `parameters` in place so that their joint
    `norm_type` norm is at most `max_norm`; returns that norm (f32)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = sum((g.float().abs() ** norm_type).sum()
                    for g in grads) ** (1.0 / norm_type)
    coef = (float(max_norm) / (total + 1e-6)).clamp(max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = p.grad * coef.to(p.grad.dtype)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clip the `.grad` of `parameters` to [-clip_value, clip_value]."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad = p.grad.clamp(-clip_value, clip_value)
