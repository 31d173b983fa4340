"""The optimizer base and the update-rule zoo (``paddle_tpu/optimizer/
optimizer.py`` counterpart: `Optimizer` :35-259, `SGD` :261, `Momentum`
:271, `Adagrad` :294, `Adam` :313, `AdamW` :358, `Adamax` :387,
`RMSProp` :411, `Lamb` :445, `Adadelta` :484, `Rprop` :509, `LBFGS`
:540; `L2Decay` / `L1Decay` :25-33).

One rule per optimizer, as in the JAX package, where `update(p, g,
slots, lr, t, wd)` is the single source of truth of both `.step()` and
`apply_gradients`: here each optimizer writes its rule once as
`_update(ps, gs, slots, lr, t, wd)` over lists of f32 tensors
(``torch._foreach_*`` where one exists), updating the parameters and
the slots in place, and both paths call it.  The rule never writes into
`gs` (in `.step()` they are the parameters' own gradients).

Functional path (the train step's): state is ``{"slots": {name:
slots}, "step": t}`` with f32 slots under the JAX slot names.  The step
count is an int32 device tensor and `apply_gradients(..., lr=)` takes
the learning rate as an f32 device tensor; the bias corrections are
computed from the step on the device, in f32 as the JAX rules compute
them.  So an update captured into a CUDA graph reads the step and the
rate each time it is replayed, where host values would be frozen at
the capture (`distributed/train_step.py`).  A plain int step is still
accepted, and becomes a tensor at its first update.  Weight decay is
the uniform `_functional_wd()` (an `L2Decay`'s coefficient, JAX :101).

Eager path: ``loss.backward(); opt.step(); opt.clear_grad()``.  The
constructor takes a list of parameters or of group dicts (a group's
``learning_rate`` multiplies the rate through the parameter's
``optimize_attr``, its ``weight_decay`` overrides the decay, JAX
:42-64), a float ``weight_decay`` (an `L2Decay`), ``grad_clip`` (called
on the ``(param, grad)`` pairs, `nn.clip`), and ``multi_precision``: a
parameter that is not f32 gets an f32 master, which the rule updates
and whose cast is copied back (JAX `_master` :144).  A parameter that is
not f32 and has no master is updated in an f32 copy and cast back, as
the JAX step does.  `.step()` runs the rule once per (rate, decay,
device) group of parameters, with the step count on the device;
parameters are updated in place, so CUDA graphs holding them (a
`to_static` program) stay valid.  `state_dict` uses the JAX keys:
``param_{i}.{slot}``, ``param_{i}.master_weight``, ``@step``,
``LR_Scheduler``.

As in the JAX package, `L1Decay` is accepted and applies nothing (its
`_wd_for` and `_functional_wd` read only `L2Decay`), and AdamW's
``lr_ratio`` and ``lazy_mode`` are accepted and unused.  `LBFGS` is
eager only: ``step(closure)`` runs the two-loop recursion and the
Armijo backtracking with host reads; its functional rule raises
NotImplementedError, as the JAX base `update` does (:99).
"""
from __future__ import annotations

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["L1Decay", "L2Decay", "Optimizer", "SGD", "Momentum", "Adagrad",
           "Adam", "AdamW", "Adamax", "RMSProp", "Lamb", "Adadelta", "Rprop",
           "LBFGS"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


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


def _zeros(p, fill=0.0):
    return torch.full(p.shape, fill, dtype=torch.float32, device=p.device)


def _lr_mult(p) -> float:
    return float(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0))


class Optimizer:
    """The base: the rate (a number or an `LRScheduler`, JAX :79-91),
    the functional `init_state` / `apply_gradients` and the eager
    `step` / `clear_grad` / `minimize` / `state_dict` around one rule,
    `_update`, that subclasses write."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        self._per_param_wd = {}  # id(param) -> weight-decay coeff override
        self._param_groups = None
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                self._param_groups = parameters
                flat = []
                for g in parameters:
                    plist = list(g["params"])
                    # a group's learning_rate multiplies the base rate
                    # (ParamAttr.learning_rate); its weight_decay
                    # overrides the coefficient
                    if "learning_rate" in g:
                        for p in plist:
                            p.__dict__.setdefault("optimize_attr", {})[
                                "learning_rate"] = float(g["learning_rate"])
                    if "weight_decay" in g:
                        wd = g["weight_decay"]
                        coeff = wd.coeff if hasattr(wd, "coeff") \
                            else float(wd)
                        for p in plist:
                            self._per_param_wd[id(p)] = coeff
                    flat.extend(plist)
                parameters = flat
        self._parameter_list = parameters
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)
        if isinstance(weight_decay, float):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators = {}    # id(param) -> {slot: f32 tensor}
        self._master_weights = {}  # id(param) -> f32 tensor
        self._step_count = 0

    # --- lr ------------------------------------------------------------------
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

    # --- the rule (override) -------------------------------------------------
    def init_slots(self, p) -> dict:
        """slot name -> initial f32 tensor for one parameter."""
        return {}

    def _update(self, ps, gs, slots, lr, t, wd) -> None:
        """In place: ps (f32 parameters) and slots (slot name -> list
        parallel to ps), from gs (f32 gradients, read only), the rate lr
        (0-dim f32 tensor), the step t (0-dim int32 tensor, already
        advanced) and the decay coefficient wd (a float)."""
        raise NotImplementedError

    def _functional_wd(self) -> float:
        """The uniform weight-decay coefficient of the functional path."""
        return self._weight_decay.coeff if isinstance(
            self._weight_decay, L2Decay) else 0.0

    def _wd_for(self, p) -> float:
        """A parameter's weight-decay coefficient (group overrides;
        exclusion functions in subclasses)."""
        if id(p) in self._per_param_wd:
            return self._per_param_wd[id(p)]
        return self._weight_decay.coeff if isinstance(
            self._weight_decay, L2Decay) else 0.0

    def _run(self, ps, gs, slot_dicts, lr, t, wd) -> None:
        """The rule on parameters of any float dtype: those that are not
        f32 are updated in an f32 copy and cast back."""
        base = [p if p.dtype == torch.float32 else p.float() for p in ps]
        keys = list(slot_dicts[0]) if slot_dicts else []
        self._update(base, [g.float() for g in gs],
                     {k: [s[k] for s in slot_dicts] for k in keys}, lr, t,
                     wd)
        for p, b in zip(ps, base):
            if b is not p:
                p.copy_(b)

    # --- functional API (the train step's) -----------------------------------
    def init_state(self, params: dict) -> dict:
        """params: name -> tensor.  f32 slots and step 0."""
        return {"slots": {n: self.init_slots(p) for n, p in params.items()},
                "step": _zero_step(params)}

    @torch.no_grad()
    def apply_gradients(self, params: dict, grads: dict, state: dict,
                        lr=None):
        """One step of the rule on `params` in place; a name whose
        gradient is None is skipped.  Returns (params, state)."""
        dev = _device(params)
        lr = _lr_tensor(lr, self.get_lr(), dev)
        t = _advance(state, dev)
        names = [n for n in params if grads.get(n) is not None]
        self._run([params[n] for n in names], [grads[n] for n in names],
                  [state["slots"][n] for n in names], lr, t,
                  self._functional_wd())
        return params, state

    # --- eager path ----------------------------------------------------------
    @property
    def _params(self):
        if self._parameter_list is None:
            raise ValueError("optimizer constructed without parameters")
        return self._parameter_list

    def _get_slots(self, p) -> dict:
        key = id(p)
        if key not in self._accumulators:
            self._accumulators[key] = self.init_slots(p)
        return self._accumulators[key]

    def _master(self, p):
        if not self._multi_precision or p.dtype == torch.float32:
            return None
        key = id(p)
        if key not in self._master_weights:
            self._master_weights[key] = p.detach().float()
        return self._master_weights[key]

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient."""
        self._step_count += 1
        params_grads = [(p, p.grad) for p in self._params
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        groups = {}
        for p, g in params_grads:
            key = (lr * _lr_mult(p), self._wd_for(p), p.device)
            groups.setdefault(key, []).append((p, g))
        for (plr, wd, dev), items in groups.items():
            t = torch.full((), self._step_count, dtype=torch.int32,
                           device=dev)
            masters = [self._master(p) for p, _ in items]
            targets = [p if m is None else m
                       for (p, _), m in zip(items, masters)]
            self._run(targets, [g for _, g in items],
                      [self._get_slots(p) for p, _ in items],
                      torch.full((), plr, dtype=torch.float32, device=dev),
                      t, wd)
            for (p, _), m in zip(items, masters):
                if m is not None:
                    p.copy_(m)

    def clear_grad(self, set_to_zero=True):
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The eager branch of the JAX `minimize` (:210): backward, step,
        clear."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # --- state dict ----------------------------------------------------------
    def _names(self) -> dict:
        return {id(p): getattr(p, "name", None) or f"param_{i}"
                for i, p in enumerate(self._params)}

    def state_dict(self) -> dict:
        """The slots and masters under the JAX keys, the step and the
        scheduler's state."""
        out = {}
        name_of = self._names()
        for pid, slots in self._accumulators.items():
            base = name_of.get(pid, str(pid))
            for k, v in slots.items():
                out[f"{base}.{k}"] = v
        for pid, mw in self._master_weights.items():
            out[f"{name_of.get(pid, str(pid))}.master_weight"] = mw
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state) -> None:
        """Load a `state_dict` of either package (values: tensors, numpy
        arrays or anything `np.asarray` takes); slots that exist are
        copied into, so their addresses stay."""
        by_name = {n: p for p, n in zip(self._params,
                                        self._names().values())}
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for k, v in state.items():
            if k in ("@step", "LR_Scheduler"):
                continue
            base, slot = k.rsplit(".", 1)
            p = by_name.get(base)
            if p is None:
                continue
            val = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(np.asarray(v), dtype=np.float32))
            val = val.to(device=p.device, dtype=torch.float32)
            if slot == "master_weight":
                have = self._master_weights.get(id(p))
                if have is None:
                    self._master_weights[id(p)] = val.clone()
                else:
                    have.copy_(val)
            else:
                slots = self._get_slots(p)
                if slot in slots:
                    slots[slot].copy_(val)
                else:
                    slots[slot] = val.clone()


def _l2(gs, ps, wd):
    """L2 decay into the gradient (out of place)."""
    return torch._foreach_add(gs, ps, alpha=wd) if wd else gs


class SGD(Optimizer):
    """p -= lr * (g + wd * p)."""

    def _update(self, ps, gs, slots, lr, t, wd):
        gs = _l2(gs, ps, wd)
        torch._foreach_sub_(ps, torch._foreach_mul(gs, lr))


class Momentum(Optimizer):
    """SGD with momentum: v = mu * v + g, then p -= lr * v, or with
    Nesterov p -= lr * (g + mu * v); weight decay is L2 added to the
    gradient first."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def init_slots(self, p):
        return {"velocity": _zeros(p)}

    def _update(self, ps, gs, slots, lr, t, wd):
        gs = _l2(gs, ps, wd)
        v = slots["velocity"]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, gs)
        if self._nesterov:
            step = torch._foreach_add(gs, v, alpha=self._momentum)
        else:
            step = v
        torch._foreach_sub_(ps, torch._foreach_mul(step, lr))


class Adagrad(Optimizer):
    """m += g^2; p -= lr * g / (sqrt(m) + eps)."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_slots(self, p):
        return {"moment": _zeros(p, self._init_acc)}

    def _update(self, ps, gs, slots, lr, t, wd):
        gs = _l2(gs, ps, wd)
        m = slots["moment"]
        torch._foreach_addcmul_(m, gs, gs)
        denom = torch._foreach_sqrt(m)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_mul(gs, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ps, upd)


class Adam(Optimizer):
    """Adam, with ``amsgrad`` the running max of the second moment
    (slot ``moment2_max``); weight decay is L2 added to the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def init_slots(self, p):
        s = {"moment1": _zeros(p), "moment2": _zeros(p)}
        if self._amsgrad:
            s["moment2_max"] = _zeros(p)
        return s

    def _decay(self, ps, gs, lr, wd):
        """Weight decay before the moment update: L2 into the gradient."""
        return _l2(gs, ps, wd)

    def _update(self, ps, gs, slots, lr, t, wd):
        """p -= lr * m_hat / (sqrt(v_hat) + eps), with m_hat = m / (1 -
        beta1^t) and v_hat = v / (1 - beta2^t) (v its running max under
        amsgrad)."""
        t = t.float()
        m, v = slots["moment1"], slots["moment2"]
        gs = self._decay(ps, gs, lr, wd)
        b1, b2 = self._beta1, self._beta2
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, gs, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, gs, gs, value=1 - b2)
        if self._amsgrad:
            torch._foreach_maximum_(slots["moment2_max"], v)
            v = slots["moment2_max"]
        denom = torch._foreach_sqrt(torch._foreach_div(v, 1 - b2 ** t))
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_div(m, 1 - b1 ** t)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ps, upd)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01): p * (1 - lr *
    wd) before the Adam update.  The functional path decays every
    parameter; `.step()` skips those `apply_decay_param_fun(p.name)`
    rejects, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad, name)
        self._coeff = weight_decay if isinstance(weight_decay, float) else \
            getattr(weight_decay, "coeff", 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._weight_decay = L2Decay(self._coeff)

    def _wd_for(self, p):
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(getattr(p, "name", None)):
            return 0.0
        return super()._wd_for(p)

    def _decay(self, ps, gs, lr, wd):
        if wd:
            torch._foreach_mul_(ps, 1.0 - lr * wd)
        return gs


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g; u = max(b2 u, |g|); p -= lr / (1 - b1^t)
    * m / (u + eps)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def init_slots(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _update(self, ps, gs, slots, lr, t, wd):
        gs = _l2(gs, ps, wd)
        m, u = slots["moment"], slots["inf_norm"]
        b1 = self._beta1
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, gs, alpha=1 - b1)
        torch._foreach_mul_(u, self._beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(gs))
        rate = lr / (1 - b1 ** t.float())
        denom = torch._foreach_add(u, self._epsilon)
        upd = torch._foreach_mul(m, rate)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ps, upd)


class RMSProp(Optimizer):
    """ms = rho ms + (1 - rho) g^2 (``centered``: mg likewise, and the
    denominator sqrt(ms - mg^2 + eps)); mom = momentum * mom + lr * g /
    denom; p -= mom."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def init_slots(self, p):
        s = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            s["mean_grad"] = _zeros(p)
        return s

    def _update(self, ps, gs, slots, lr, t, wd):
        gs = _l2(gs, ps, wd)
        rho = self._rho
        ms = slots["mean_square"]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, gs, gs, value=1 - rho)
        if self._centered:
            mg = slots["mean_grad"]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, gs, alpha=1 - rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1.0)
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        mom = slots["momentum"]
        torch._foreach_mul_(mom, self._momentum)
        upd = torch._foreach_mul(gs, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(mom, upd)
        torch._foreach_sub_(ps, mom)


class Lamb(Optimizer):
    """Adam's moments, then r = m_hat / (sqrt(v_hat) + eps) + wd * p and
    p -= lr * trust * r, the trust ratio ||p|| / ||r|| per tensor (1 where
    either norm is 0)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._wd = lamb_weight_decay
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _wd_for(self, p):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return self._wd

    def _functional_wd(self):
        return self._wd

    def init_slots(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _update(self, ps, gs, slots, lr, t, wd):
        t = t.float()
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, gs, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, gs, gs, value=1 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div(v, 1 - b2 ** t))
        torch._foreach_add_(denom, self._epsilon)
        r = torch._foreach_div(m, 1 - b1 ** t)
        torch._foreach_div_(r, denom)
        if wd:
            torch._foreach_add_(r, ps, alpha=wd)
        w_norm = torch.stack(torch._foreach_norm(ps))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0) * lr
        for ri, tr in zip(r, trust.unbind()):
            ri.mul_(tr)
        torch._foreach_sub_(ps, r)


class Adadelta(Optimizer):
    """asg = rho asg + (1 - rho) g^2; upd = g sqrt(asu + eps) / sqrt(asg
    + eps); asu = rho asu + (1 - rho) upd^2; p -= lr * upd."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon = epsilon
        self._rho = rho

    def init_slots(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _update(self, ps, gs, slots, lr, t, wd):
        gs = _l2(gs, ps, wd)
        rho, eps = self._rho, self._epsilon
        asg, asu = slots["avg_squared_grad"], slots["avg_squared_update"]
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, gs, gs, value=1 - rho)
        num = torch._foreach_sqrt(torch._foreach_add(asu, eps))
        den = torch._foreach_sqrt(torch._foreach_add(asg, eps))
        upd = torch._foreach_mul(gs, num)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
        torch._foreach_sub_(ps, torch._foreach_mul(upd, lr))


class Rprop(Optimizer):
    """Resilient backprop: per-element step sizes grown or shrunk by the
    agreement of the gradient's sign with the last one, clipped to
    `learning_rate_range`; on a sign flip no step, and the remembered
    gradient is zeroed.  `delta` starts at `get_lr()` (JAX :523)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def init_slots(self, p):
        return {"delta": _zeros(p, self.get_lr()),
                "prev_grad": _zeros(p)}

    def _update(self, ps, gs, slots, lr, t, wd):
        for p, g, delta, prev in zip(ps, gs, slots["delta"],
                                     slots["prev_grad"]):
            sign = torch.sign(g * prev)
            grown = torch.where(sign > 0, delta * self._eta_pos,
                                torch.where(sign < 0,
                                            delta * self._eta_neg, delta))
            delta.copy_(grown.clamp(self._lr_min, self._lr_max))
            g_eff = torch.where(sign < 0, 0.0, g)
            p.sub_(torch.sign(g_eff) * delta)
            prev.copy_(g_eff)


class LBFGS(Optimizer):
    """L-BFGS with the two-loop recursion and an Armijo backtracking line
    search.  ``step(closure)``: the closure re-evaluates the loss (and
    its gradients); it runs on the host's schedule, reading the loss and
    the directions back each iteration, so it has no functional rule."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=10, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self.max_iter = max_iter
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s_hist = []
        self._y_hist = []

    def _update(self, ps, gs, slots, lr, t, wd):
        raise NotImplementedError(
            "LBFGS has no functional rule (as in the JAX package): call "
            "step(closure) in an eager loop")

    def _flat_params(self):
        return torch.cat([p.detach().float().reshape(-1)
                          for p in self._parameter_list])

    def _flat_grads(self):
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .float().reshape(-1) for p in self._parameter_list])

    @torch.no_grad()
    def _assign_flat(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    def step(self, closure=None):
        assert closure is not None, \
            "LBFGS.step(closure) needs a loss closure (reference API)"

        def eval_loss_grads():
            self.clear_grad()
            with torch.enable_grad():
                loss = closure()
            return float(loss)

        loss = eval_loss_grads()
        for _ in range(self.max_iter):
            g = self._flat_grads()
            if float(g.abs().max()) < self.tol_grad:
                break
            # two-loop recursion
            q = g
            alphas = []
            for s, y in reversed(list(zip(self._s_hist, self._y_hist))):
                rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
                a = rho * torch.dot(s, q)
                alphas.append((a, rho, s, y))
                q = q - a * y
            if self._y_hist:
                y_l, s_l = self._y_hist[-1], self._s_hist[-1]
                gamma = torch.dot(s_l, y_l) / torch.clamp(
                    torch.dot(y_l, y_l), min=1e-10)
                q = q * gamma
            for a, rho, s, y in reversed(alphas):
                b = rho * torch.dot(y, q)
                q = q + s * (a - b)
            d = -q
            # Armijo backtracking
            x0 = self._flat_params()
            g0_d = float(torch.dot(g, d))
            t = self.get_lr()
            ok = False
            for _ls in range(20):
                self._assign_flat(x0 + t * d)
                new_loss = eval_loss_grads()
                if new_loss <= loss + 1e-4 * t * g0_d:
                    ok = True
                    break
                t *= 0.5
            if not ok:
                self._assign_flat(x0)
                eval_loss_grads()
                break
            s_vec = t * d
            new_g = self._flat_grads()
            y_vec = new_g - g
            if float(torch.dot(s_vec, y_vec)) > 1e-10:
                self._s_hist.append(s_vec)
                self._y_hist.append(y_vec)
                if len(self._s_hist) > self.history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
            if abs(new_loss - loss) < self.tol_change:
                loss = new_loss
                break
            loss = new_loss
        return loss
