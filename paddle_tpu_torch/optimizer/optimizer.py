"""Momentum, Adam and AdamW, the functional rules of ``paddle_tpu/
optimizer/optimizer.py`` (`Optimizer.init_state` / `apply_gradients`
:107-135, `Momentum.update` :271-291, `Adam.update` :336-352, `AdamW`
:358-384).

State is a dict ``{"slots": {name: slots}, "step": t}`` with f32 slots
(Momentum's `velocity`, Adam's `moment1` and `moment2`), as in the JAX
package.  Where the JAX rule returns new arrays, `apply_gradients` here
updates the parameters, the slots and the step in place
(``torch._foreach_*``), which saves a copy of both; it returns them for
symmetry.

The step count is an int32 device tensor and `apply_gradients(...,
lr=)` takes the learning rate as an f32 device tensor (the JAX
`apply_gradients` takes ``lr`` too); the bias corrections are computed
from the step on the device, in f32 as the JAX rule computes them.  So
an update captured into a CUDA graph reads the step and the rate each
time it is replayed, where host values would be frozen at the capture
(`distributed/train_step.py`).  A plain int step is still accepted, and
becomes a tensor at its first update.  ``learning_rate`` is a number
or an `LRScheduler` (`optimizer/lr.py`), as in the JAX package
(:79-91): `get_lr()` reads the scheduler, `set_lr` raises while one is
set, `set_lr_scheduler` sets one.  Amsgrad, parameter groups and the
other optimizers are not ported; gradient clipping is the train step's
``grad_clip_norm``.
"""
from __future__ import annotations

import torch

from .lr import LRScheduler


class _Rate:
    """The learning rate of an optimizer: a number or a scheduler (JAX
    `Optimizer.get_lr` / `set_lr` / `set_lr_scheduler`, :79-91)."""

    def __init__(self, learning_rate):
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._learning_rate = scheduler


def _device(params) -> torch.device:
    return next(iter(params.values())).device if params \
        else torch.device("cpu")


def _zero_step(params):
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _advance(state, device):
    """t = step + 1, in place on the state's int32 device tensor (a
    plain int becomes one first); returns t."""
    t = state["step"]
    if not isinstance(t, torch.Tensor):
        t = torch.full((), int(t), dtype=torch.int32, device=device)
        state["step"] = t
    return t.add_(1)


def _lr_tensor(lr, default, device):
    """The learning rate as a 0-dim f32 tensor: a tensor is used as it
    is (the train step's, which a graph reads); a float, or None for the
    optimizer's own rate, is put on `device`."""
    if isinstance(lr, torch.Tensor):
        return lr
    return torch.full((), default if lr is None else float(lr),
                      dtype=torch.float32, device=device)


def _with_grads(params, grads):
    """The names whose gradient is not None, their f32 master parameters
    and their gradients in f32."""
    names = [n for n in params if grads.get(n) is not None]
    ps = [params[n] for n in names]
    if any(p.dtype != torch.float32 for p in ps):
        raise TypeError("apply_gradients updates float32 (master) "
                        "parameters only")
    return names, ps, [grads[n].float() for n in names]


class Momentum(_Rate):
    """SGD with momentum: v = mu * v + g, then p -= lr * v, or with
    Nesterov p -= lr * (g + mu * v); weight decay, when given, is L2
    added to the gradient first.  `parameters` is accepted for the
    reference's signature; the train step passes the parameters to
    `apply_gradients` itself."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None):
        super().__init__(learning_rate)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)
        self._coeff = float(weight_decay or 0.0)

    def init_state(self, params: dict) -> dict:
        """params: name -> tensor.  Zero f32 velocities and step 0."""
        slots = {n: {"velocity": torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)}
                 for n, p in params.items()}
        return {"slots": slots, "step": _zero_step(params)}

    @torch.no_grad()
    def apply_gradients(self, params: dict, grads: dict, state: dict,
                        lr=None):
        """One step on f32 parameters, in place: p -= lr * v.  A name
        whose gradient is None is skipped.  Returns (params, state)."""
        dev = _device(params)
        lr = _lr_tensor(lr, self.get_lr(), dev)
        names, ps, gs = _with_grads(params, grads)
        if self._coeff:
            gs = torch._foreach_add(gs, ps, alpha=self._coeff)
        v = [state["slots"][n]["velocity"] for n in names]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, gs)
        if self._nesterov:
            step = torch._foreach_add(gs, v, alpha=self._momentum)
        else:
            step = v
        torch._foreach_sub_(ps, torch._foreach_mul(step, lr))
        _advance(state, dev)
        return params, state


class Adam(_Rate):
    """Adam; weight decay, when given, is L2 added to the gradient.
    `parameters` is accepted for the reference's signature; the train
    step passes the parameters to `apply_gradients` itself."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None):
        super().__init__(learning_rate)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._coeff = float(weight_decay or 0.0)

    def init_state(self, params: dict) -> dict:
        """params: name -> tensor.  Zero f32 moments and step 0."""
        slots = {n: {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device),
                     "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)}
                 for n, p in params.items()}
        return {"slots": slots, "step": _zero_step(params)}

    def _decay(self, ps, gs, lr):
        """Weight decay before the moment update: L2 into the gradient."""
        if self._coeff:
            gs = torch._foreach_add(gs, ps, alpha=self._coeff)
        return gs

    @torch.no_grad()
    def apply_gradients(self, params: dict, grads: dict, state: dict,
                        lr=None):
        """One step on f32 parameters, in place: p -= lr * m_hat /
        (sqrt(v_hat) + eps), with m_hat = m / (1 - beta1^t) and v_hat =
        v / (1 - beta2^t).  A name whose gradient is None is skipped.
        Returns (params, state)."""
        dev = _device(params)
        lr = _lr_tensor(lr, self.get_lr(), dev)
        t = _advance(state, dev).float()
        names, ps, gs = _with_grads(params, grads)
        m = [state["slots"][n]["moment1"] for n in names]
        v = [state["slots"][n]["moment2"] for n in names]
        gs = self._decay(ps, gs, lr)
        b1, b2 = self._beta1, self._beta2
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, gs, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, gs, gs, value=1 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div(v, 1 - b2 ** t))
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_div(m, 1 - b1 ** t)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ps, upd)
        return params, state


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01): p * (1 - lr * wd)
    before the Adam update, on every parameter, as the JAX functional
    path applies it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay)

    def _decay(self, ps, gs, lr):
        if self._coeff:
            torch._foreach_mul_(ps, 1.0 - lr * self._coeff)
        return gs
