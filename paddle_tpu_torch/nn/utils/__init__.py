"""paddle.nn.utils (``paddle_tpu/nn/utils/__init__.py`` counterpart):
gradient clipping helpers, parameter flattening, and the weight-norm and
spectral-norm reparametrisations.

`weight_norm` makes `<name>_g` and `<name>_v` parameters and recomputes
the effective weight in a forward pre-hook, in f32 with
``max(norm, 1e-12)`` (JAX :84-122), not through
`torch.nn.utils.weight_norm`.  `spectral_norm` keeps its power-iteration
vector `u` as a non-persistent buffer (``_sn_u``; JAX keeps it as a
plain attribute, outside `functional_state()`), drawn from
``RandomState(0)`` as in JAX so that both packages start from the same
vector, and updated at every forward.  Both hooks compute on the
parameters themselves, so gradients reach them as `jax.grad` of the JAX
layer's `functional_call` gives them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..layer_base import Parameter

__all__ = [
    "clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
    "vector_to_parameters", "weight_norm", "remove_weight_norm",
    "spectral_norm",
]


def _list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the `.grad` of `parameters` in place by ``min(1, max_norm /
    max(total, 1e-12))``, the scale applied in f32; returns the total
    norm (JAX :30; not `nn.clip`'s ``total + 1e-6`` rule)."""
    params = [p for p in _list(parameters) if p.grad is not None]
    if not params:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max().float()
                             for p in params]).max()
    else:
        total = torch.stack([
            (p.grad.float().abs() ** norm_type).sum()
            for p in params]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            f"non-finite total norm {float(total)} in clip_grad_norm_")
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in params:
        p.grad = (p.grad.float() * scale).to(p.grad.dtype)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp the `.grad` of `parameters` to [-clip_value, clip_value]."""
    for p in _list(parameters):
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -clip_value, clip_value)


def parameters_to_vector(parameters, name=None):
    """The parameters flattened into one 1-D tensor."""
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of `vec` into the parameters, in place."""
    parameters = list(parameters)
    need = sum(p.numel() for p in parameters)
    if need != vec.shape[0]:
        raise ValueError(f"vector has {vec.shape[0]} elements; parameters "
                         f"need {need}")
    off = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[off:off + n].reshape(p.shape).to(p.dtype))
        off += n


def _norm_except_dim(w, dim):
    dims = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(w.float()), dims, keepdim=True))


def _norm(w, dim):
    if dim == -1:
        return torch.sqrt(torch.sum(torch.square(w.float())))
    return _norm_except_dim(w, dim)


def _detach_after(layer, name):
    """After each forward, `layer.<name>` (the effective weight a
    pre-hook set) is kept detached: the backward holds its own
    references, and a module holding a non-leaf tensor cannot be
    deep-copied (to move it to another device, say)."""
    def post(lyr, inputs, output):
        lyr.__dict__[name] = lyr.__dict__[name].detach()

    return layer.register_forward_hook(post)


def _rebind_parameter(layer, name, value):
    """`layer.<name>` a new parameter holding `value`."""
    if name in layer._parameters:
        del layer._parameters[name]
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, Parameter(value.detach().clone()))


def weight_norm(layer, name="weight", dim=0):
    """Reparametrise `layer.<name>` as g * v / ||v|| (norm over every
    axis but `dim`; over all with ``dim=None``)."""
    w = getattr(layer, name)
    if dim is None:
        dim = -1
    with torch.no_grad():
        g0 = _norm(w, dim)
        if dim == -1:
            g0 = g0.reshape((1,) * w.dim())
    _rebind_parameter(layer, name + "_g", g0.to(w.dtype))
    _rebind_parameter(layer, name + "_v", w)
    del layer._parameters[name]

    def hook(lyr, inputs):
        vv = getattr(lyr, name + "_v")
        gg = getattr(lyr, name + "_g").float()
        eff = vv.float() / torch.clamp(_norm(vv, dim), min=1e-12) * gg
        lyr.__dict__[name] = eff.to(vv.dtype)

    with torch.no_grad():
        hook(layer, None)
    handles = (layer.register_forward_pre_hook(hook),
               _detach_after(layer, name))
    layer.__dict__.setdefault("_weight_norm_hooks", {})[name] = (handles,
                                                                dim)
    return layer


def remove_weight_norm(layer, name="weight"):
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"no weight_norm hook on {name!r}")
    handles, _ = hooks.pop(name)
    for handle in handles:
        handle.remove()
    _rebind_parameter(layer, name, layer.__dict__[name])
    for suffix in ("_g", "_v"):
        del layer._parameters[name + suffix]
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide `layer.<name>` by its largest singular value, estimated by
    power iteration from the kept vector `u` at every forward (JAX
    :144)."""
    w = getattr(layer, name)
    if dim is None:
        dim = 0
    rows = w.shape[dim]
    u = np.random.RandomState(0).randn(rows).astype(np.float32)
    u = torch.from_numpy(u).to(w.device)
    layer.register_buffer("_sn_u", u / torch.clamp(torch.linalg.norm(u),
                                                   min=eps),
                          persistable=False)
    _rebind_parameter(layer, name + "_orig", w)
    del layer._parameters[name]

    def hook(lyr, inputs):
        w2 = getattr(lyr, name + "_orig")
        m = torch.movedim(w2, dim, 0).reshape(w2.shape[dim], -1).float()
        u_ = lyr._sn_u
        for _ in range(n_power_iterations):
            v_ = m.T @ u_
            v_ = v_ / torch.clamp(torch.linalg.norm(v_), min=eps)
            u_ = m @ v_
            u_ = u_ / torch.clamp(torch.linalg.norm(u_), min=eps)
        lyr._sn_u = u_.detach()
        sigma = u_ @ (m @ v_)
        eff = w2.float() / torch.clamp(sigma, min=eps)
        lyr.__dict__[name] = eff.to(w2.dtype)

    with torch.no_grad():
        hook(layer, None)
    layer.register_forward_pre_hook(hook)
    _detach_after(layer, name)
    return layer
