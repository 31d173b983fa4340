"""In-step NaN/Inf guards (``paddle_tpu/resilience/guards.py``
counterpart): finiteness reductions on the device, in the train step,
plus the host-side warn → skip → rollback escalation.

Two layers, split along the host/device boundary:

* device (no host sync, inside the step's CUDA graph; torch is
  imported by the two functions, so the package imports without it):
  `tree_finite(loss, grads)` reduces the loss and every floating
  gradient to ONE boolean tensor; `tree_select(ok, new, old)` keeps the
  previous state when the step went bad.  With `ok` true the selected
  values are the new ones bit for bit (`torch.where` selects, it does
  not recompute), so a guarded step with no faults matches the
  unguarded trajectory exactly.
* host (`StepGuard`, a copy of the JAX class): consumes the per-step ok
  flag (one scalar read), counts CONSECUTIVE bad steps and escalates:
      1st bad        → "warn"  (flight event, counter — state already
                                 kept by the in-step select)
      2..K-1th bad   → "skip"
      Kth bad        → "rollback" (invokes the registered callback —
                                 typically the train step's `rollback`,
                                 through its CheckpointManager — and
                                 resets the streak)
  ``source="amp"`` / ``"amp_floor"`` keep the JAX package's meaning for
  a loss scaler's overflow reports.
"""
from __future__ import annotations

import threading

__all__ = ["tree_finite", "tree_select", "StepGuard", "RollbackError"]


class RollbackError(RuntimeError):
    """Escalation reached rollback but no rollback callback is
    registered (or the callback itself failed)."""


def tree_finite(loss, grads=None):
    """One 0-dim bool tensor on the loss's device: the loss and every
    floating gradient all finite.  No host read."""
    import torch

    ok = torch.isfinite(loss).all()
    for g in grads or ():
        if g is not None and g.is_floating_point():
            ok = ok & torch.isfinite(g).all()
    return ok


def tree_select(ok, new, old):
    """``where(ok, n, o)`` for each pair of tensors of the lists `new`
    and `old`: a bad step keeps the old values, with no host read."""
    import torch

    return [torch.where(ok, n, o) for n, o in zip(new, old)]


class StepGuard:
    """Host-side escalation ladder over per-step finiteness flags.

    observe(ok) → "ok" | "warn" | "skip" | "rollback".  Thread-safe;
    wire a rollback with `on_rollback=` (callable, no args) or
    `set_rollback(fn)` — DistributedTrainStep does this automatically
    when it owns a CheckpointManager.
    """

    def __init__(self, max_consecutive_bad=3, on_rollback=None,
                 raise_without_rollback=True, name="train"):
        self.max_consecutive_bad = max(1, int(max_consecutive_bad))
        self.on_rollback = on_rollback
        self.raise_without_rollback = bool(raise_without_rollback)
        self.name = str(name)
        self._lock = threading.Lock()
        self.consecutive_bad = 0
        self.total_bad = 0
        self.total_steps = 0
        self.rollbacks = 0

    def set_rollback(self, fn):
        self.on_rollback = fn

    def observe(self, ok, source="guard"):
        """Feed one step's finiteness verdict; returns the action taken.

        source="amp": a GradScaler-reported overflow.  While the scaler
        still has room to decrease the loss scale this is part of normal
        dynamic-scaling operation — recorded (counter + flight) but not
        escalated.  Pass source="amp_floor" (scaler at minimum scale)
        to count it against the streak like a guard-detected bad step.
        """
        ok = bool(ok)
        with self._lock:
            self.total_steps += 1
            if ok:
                self.consecutive_bad = 0
                return "ok"
            self.total_bad += 1
            if source == "amp":
                self._emit("skip", source)
                return "skip"
            self.consecutive_bad += 1
            streak = self.consecutive_bad
            if streak >= self.max_consecutive_bad:
                self.consecutive_bad = 0
                self.rollbacks += 1
                action = "rollback"
            elif streak == 1:
                action = "warn"
            else:
                action = "skip"
        self._emit(action, source, streak=streak)
        if action == "rollback":
            self._rollback(streak)
        return action

    def _rollback(self, streak):
        cb = self.on_rollback
        if cb is None:
            if self.raise_without_rollback:
                raise RollbackError(
                    f"guard {self.name!r}: {streak} consecutive non-finite "
                    f"steps and no rollback target registered")
            return
        try:
            cb()
        except Exception as e:
            raise RollbackError(
                f"guard {self.name!r}: rollback callback failed: {e}") from e

    def _emit(self, action, source, streak=None):
        try:
            from ..observability import flight as _flight
            from ..observability import metrics as _metrics

            if action in ("warn", "skip"):
                _metrics.inc("resilience.skipped_steps", source=source)
            elif action == "rollback":
                _metrics.inc("resilience.rollbacks")
            extra = {} if streak is None else {"streak": streak}
            _flight.record(f"resilience.guard_{action}", guard=self.name,
                           source=source, **extra)
        except Exception:  # pt-lint: ok[PT005] (observability fan-out
            pass           # guard: guarding must not depend on telemetry)

    def state_dict(self):
        with self._lock:
            return {"consecutive_bad": self.consecutive_bad,
                    "total_bad": self.total_bad,
                    "total_steps": self.total_steps,
                    "rollbacks": self.rollbacks}
