"""Callbacks (parity: `python/paddle/hapi/callbacks.py`)."""
from __future__ import annotations

import numbers
import time



class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and self.log_freq and step % self.log_freq == 0:
            logs = logs or {}
            parts = []
            for k, v in logs.items():
                if k == "step":
                    continue
                if isinstance(v, (list, tuple)):
                    v = v[0] if v else 0.0
                if isinstance(v, numbers.Number):
                    parts.append(f"{k}: {v:.4f}")
            print(f"  step {step}: " + ", ".join(parts))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"  epoch time: {time.time() - self.t0:.1f}s")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir or "checkpoint"

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


def _metric_comparator(mode, monitor, min_delta):
    """'min'/'max'/'auto' improvement test shared by the monitor-driven
    callbacks ('auto' infers max for accuracy-like monitors)."""
    if mode == "max" or (mode == "auto" and "acc" in monitor):
        return lambda a, b: a > b + min_delta
    return lambda a, b: a < b - min_delta


def _unwrap_metric(logs, monitor):
    cur = (logs or {}).get(monitor)
    if isinstance(cur, (list, tuple)):
        cur = cur[0] if cur else None
    return cur


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        self.better = _metric_comparator(mode, monitor, self.min_delta)

    def on_eval_end(self, logs=None):
        cur = _unwrap_metric(logs, self.monitor)
        if cur is None:
            return
        if self.best is None or self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class VisualDL(Callback):
    """Metric logger writing jsonl (the reference logs to VisualDL; here a
    dependency-free structured log with the same lifecycle)."""

    def __init__(self, log_dir="vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None

    def on_train_begin(self, logs=None):
        import os

        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(f"{self.log_dir}/metrics.jsonl", "a")

    def on_train_batch_end(self, step, logs=None):
        if self._f is None:
            return
        import json

        clean = {k: (float(v[0]) if isinstance(v, (list, tuple)) and v else
                     float(v) if isinstance(v, numbers.Number) else None)
                 for k, v in (logs or {}).items()}
        self._f.write(json.dumps({"step": step, **clean}) + "\n")

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer LR by `factor` when `monitor` stops improving
    (reference hapi/callbacks.py ReduceLROnPlateau). Works on plain-float
    learning rates (set_lr); scheduler-driven optimizers keep their
    schedule — the callback warns once and does nothing."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        if factor >= 1.0:
            raise ValueError(
                "ReduceLROnPlateau does not support a factor >= 1.0")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.wait = 0
        self.cooldown_counter = 0
        self.best = None
        self._warned = False
        self.better = _metric_comparator(mode, monitor, self.min_delta)

    def on_eval_end(self, logs=None):
        cur = _unwrap_metric(logs, self.monitor)
        if cur is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.best is None or self.better(cur, self.best):
            self.best = cur
            self.wait = 0
            return
        if self.cooldown_counter > 0:
            return
        self.wait += 1
        if self.wait < self.patience:
            return
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            return
        try:
            old = opt.get_lr()
            new = max(old * self.factor, self.min_lr)
            if new < old:
                opt.set_lr(new)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:.3g} -> {new:.3g}")
        except RuntimeError:
            if not self._warned:
                import warnings

                warnings.warn(
                    "ReduceLROnPlateau: optimizer uses an LRScheduler; "
                    "the callback cannot override it and will do nothing")
                self._warned = True
            return
        self.cooldown_counter = self.cooldown
        self.wait = 0


class WandbCallback(Callback):
    """Weights & Biases logger (reference hapi/callbacks.py WandbCallback).
    This environment has no network egress and no wandb package; the
    callback raises at construction with that reason (documented gate,
    not a silent no-op)."""

    def __init__(self, *a, **kw):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "WandbCallback requires the `wandb` package, which is not "
                "available in this environment (no network egress); use "
                "the VisualDL jsonl logger callback instead") from e
        raise NotImplementedError(
            "wandb import unexpectedly succeeded; hook up run logging "
            "before using WandbCallback")
