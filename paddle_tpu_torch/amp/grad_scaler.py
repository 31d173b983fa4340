"""GradScaler (``paddle_tpu/amp/grad_scaler.py`` counterpart:
`GradScaler` :21, `OptimizerState` :15): dynamic loss scaling for
float16.

The scale stays a host float, as in the JAX package.  `unscale_`
multiplies every gradient by 1 / scale in place (one multi-tensor
launch) and reaches the overflow verdict with one multi-tensor
max-norm over them and one host read a step, where the JAX `unscale_`
(:69-79) reads one bool per parameter: the same verdict (a gradient
with a NaN or an Inf has a non-finite max norm).  An overflowing step
calls no optimizer step, so the parameters, the slots and the step
count stay bit for bit as they were.  `update` reports to an attached
`resilience.StepGuard` as JAX :94-107 do: an overflow with room to
shrink the scale is an "amp" skip, one at the floor (or under static
scaling) "amp_floor", a clean step "amp" with ok=True.
"""
from __future__ import annotations

import enum

import torch


class OptimizerState(enum.Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._opt_state = OptimizerState.INIT
        self._guard = None

    def attach_guard(self, guard):
        """Report every `update()`'s overflow verdict to `guard` (a
        `resilience.StepGuard`): overflows while dynamic scaling can
        still shrink the scale are expected ("amp": skips, no
        escalation); one at the floor is a sick step ("amp_floor", which
        counts toward the warn -> skip -> rollback ladder)."""
        self._guard = guard
        return self

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Gradients divided by the scale in place; `_found_inf` set from
        one host read."""
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._params if p.grad is not None]
        found = False
        if grads:
            torch._foreach_mul_(grads, 1.0 / self._scale)
            peaks = torch._foreach_norm(grads, float("inf"))
            found = not bool(torch.stack([x.float() for x in peaks])
                             .isfinite().all())
        self._found_inf = found
        self._opt_state = OptimizerState.UNSCALED

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._opt_state != OptimizerState.UNSCALED:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._opt_state = OptimizerState.STEPPED

    def update(self):
        if not self._enable:
            return
        if self._guard is not None:
            # before the static-scaling return: overflows reach the guard
            # either way; static scaling (and a dynamic scale at its
            # floor) has no room to shrink out of the overflow
            if self._found_inf:
                at_floor = (not self._dynamic) or self._scale <= 1.0
                self._guard.observe(
                    False, source="amp_floor" if at_floor else "amp")
            else:
                self._guard.observe(True, source="amp")
        if not self._dynamic:
            self._opt_state = OptimizerState.INIT
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._opt_state = OptimizerState.INIT

    def minimize(self, optimizer, loss):
        scaled = self.scale(loss)
        scaled.backward()
        self.step(optimizer)
        self.update()

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d["scale"]
        self._good_steps = d["good_steps"]
        self._bad_steps = d["bad_steps"]
