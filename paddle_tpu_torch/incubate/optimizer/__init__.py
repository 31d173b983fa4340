"""incubate.optimizer counterpart (``paddle_tpu/incubate/optimizer/
__init__.py``): `LookAhead` :21, `ModelAverage` :76 and
`DistributedFusedLamb` :127, over the port's `Optimizer` and `Lamb`.

The slow and averaged copies are device tensors in each parameter's
dtype (JAX keeps them as arrays of that dtype: `ModelAverage` sums bf16
parameters in bf16, as JAX's `zeros_like` does).  Every update is in
place and reads nothing back to the host: `LookAhead`'s step count and
`ModelAverage`'s window count are host integers, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ...optimizer.optimizer import Lamb, Optimizer

__all__ = ["LookAhead", "ModelAverage", "DistributedFusedLamb"]


def _weak(value, like):
    """A Python float as JAX's weak type meets an array: rounded to the
    array's dtype (a 0-dim host tensor, which takes no device copy)."""
    return torch.tensor(value, dtype=like.dtype)


class LookAhead(Optimizer):
    """Lookahead around an inner optimizer: the inner one updates the
    fast weights every step; every `k` steps the fast weights move to
    ``slow + alpha * (fast - slow)`` and the slow copy takes them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._slow = None
        self._steps = 0

    @property
    def _parameter_list(self):
        return self.inner_optimizer._parameter_list

    @torch.no_grad()
    def step(self):
        params = self.inner_optimizer._parameter_list
        if self._slow is None:
            self._slow = [p.detach().clone() for p in params]
        self.inner_optimizer.step()
        self._steps += 1
        if self._steps % self.k == 0:
            for p, s in zip(params, self._slow):
                p.copy_(s + _weak(self.alpha, p) * (p - s))
                s.copy_(p)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        """The JAX keys: ``inner`` (the inner optimizer's state dict),
        ``steps`` and, after the first step, ``slow`` (one tensor a
        parameter)."""
        sd = {"inner": self.inner_optimizer.state_dict(),
              "steps": self._steps}
        if self._slow is not None:
            sd["slow"] = [s.clone() for s in self._slow]
        return sd

    @torch.no_grad()
    def set_state_dict(self, sd):
        """Load a `state_dict` of either package (``slow`` as tensors or
        numpy arrays), onto each parameter's device and dtype."""
        self.inner_optimizer.set_state_dict(sd.get("inner", {}))
        self._steps = sd.get("steps", 0)
        if "slow" in sd:
            self._slow = [
                (s if isinstance(s, torch.Tensor) else torch.from_numpy(
                    np.array(np.asarray(s), dtype=np.float32))).to(
                    device=p.device, dtype=p.dtype).clone()
                for p, s in zip(self._parameter_list, sd["slow"])]

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage(Optimizer):
    """Running sum of the parameters, one `step()` each; over
    `max_average_window` steps the sums are scaled back to that window.
    `apply()` puts the averages in the parameters (keeping a copy of the
    live ones), `restore()` puts the live ones back."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._parameter_list = list(parameters or [])
        self.rate = average_window_rate
        self.min_w = min_average_window
        self.max_w = max_average_window
        self._sum = [torch.zeros_like(p) for p in self._parameter_list]
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._count += 1
        for s, p in zip(self._sum, self._parameter_list):
            s.add_(p.to(s.dtype))
        # bound the window (the reference's max_average_window)
        if self._count > self.max_w:
            for s in self._sum:
                s.mul_(_weak(self.max_w / float(self._count), s))
            self._count = self.max_w

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            return
        self._backup = [p.detach().clone() for p in self._parameter_list]
        for p, s in zip(self._parameter_list, self._sum):
            p.copy_(s / self._count)

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p, b in zip(self._parameter_list, self._backup):
            p.copy_(b)
        self._backup = None

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()


class DistributedFusedLamb(Lamb):
    """`Lamb` under the reference's distributed fused name: the
    arguments map onto `Lamb`'s; the sharding and fusion options are
    taken and ignored, as in JAX (one card holds the whole state)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 clip_after_allreduce=True, is_grad_scaled_by_nranks=True,
                 alignment=128, use_master_param_norm=True, **kw):
        super().__init__(learning_rate=learning_rate,
                         lamb_weight_decay=lamb_weight_decay,
                         beta1=beta1, beta2=beta2, epsilon=epsilon,
                         parameters=parameters, grad_clip=grad_clip,
                         exclude_from_weight_decay_fn=
                         exclude_from_weight_decay_fn)
