"""ASP, n:m structured sparsity (``paddle_tpu/incubate/asp.py``
counterpart): n:m masks along the last axis, pruning a model's `Linear`
and `Conv2D` weights, and `decorate`, which puts the masks back after
each optimizer step.

The masks are computed on the parameter's device and kept there, in its
dtype: the n largest |w| of each group of m along the last axis (ties
to the lower index).  The registry is keyed by ``id(param)``, as in
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn import Conv2D, Linear

_masks = {}  # id(param) -> mask tensor on the parameter's device


def _tensor(mat):
    return mat.detach() if isinstance(mat, torch.Tensor) \
        else torch.from_numpy(np.array(np.asarray(mat)))


def calculate_density(mat):
    t = _tensor(mat)
    return float(torch.count_nonzero(t)) / max(t.numel(), 1)


def create_mask(tensor, func_name="mask_1d", n=2, m=4):
    """The n:m mask of `tensor` along its last axis (JAX :37):
    1 at the n largest |values| of each group of m, 0 elsewhere, in the
    tensor's dtype and on its device."""
    t = _tensor(tensor)
    cols = t.shape[-1]
    if cols % m != 0:
        raise ValueError(f"last dim {cols} not divisible by m={m}")
    blocks = t.reshape(-1, cols // m, m).abs()
    keep = blocks.argsort(dim=-1, descending=True, stable=True)[..., :n]
    mask = torch.zeros(blocks.shape, dtype=torch.bool, device=t.device)
    mask.scatter_(-1, keep, True)
    return mask.reshape(t.shape).to(t.dtype)


def check_sparsity(mat, n=2, m=4, func_name="check_1d"):
    """Whether every group of m along the last axis holds at most n
    non-zeros (reads one bool back to the host)."""
    t = _tensor(mat)
    if t.shape[-1] % m != 0:
        return False
    nnz = (t.reshape(-1, t.shape[-1] // m, m) != 0).sum(dim=-1)
    return bool((nnz <= n).all())


def _prunable_params(model):
    """JAX's rule (:64): the weight of every `Linear` and `Conv2D` with
    two or more dims and a last dim divisible by 4."""
    out = []
    for layer in model.modules():
        if isinstance(layer, (Linear, Conv2D)) and hasattr(layer, "weight"):
            w = layer.weight
            if w.dim() >= 2 and w.shape[-1] % 4 == 0:
                out.append(w)
    return out


@torch.no_grad()
def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Apply n:m masks to the prunable weights in place; with
    `with_mask`, remember them so that `decorate`d optimizers re-apply
    them after each step.  Returns {id(weight): mask}."""
    pruned = {}
    for w in _prunable_params(model):
        mask = create_mask(w, func_name=mask_algo, n=n, m=m)
        w.mul_(mask)
        if with_mask:
            _masks[id(w)] = mask
        pruned[id(w)] = mask
    return pruned


def decorate(optimizer):
    """Wrap `optimizer.step` so that the recorded masks multiply their
    parameters after every update (ASPHelper._decorate's role)."""
    orig_step = optimizer.step

    @torch.no_grad()
    def step():
        orig_step()
        for p in optimizer._parameter_list or []:
            mask = _masks.get(id(p))
            if mask is not None:
                p.mul_(mask)

    optimizer.step = step
    return optimizer


def reset_excluded_layers(model=None):
    _masks.clear()


def set_excluded_layers(model, layer_names):
    """Drop the masks of the named sublayers' weights."""
    for name, sub in model.named_modules():
        if name in layer_names and hasattr(sub, "weight"):
            _masks.pop(id(sub.weight), None)
