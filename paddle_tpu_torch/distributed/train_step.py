"""The train step (``paddle_tpu/distributed/train_step.py`` counterpart:
`DistributedTrainStep` :139, `__call__` :627, `run_steps` :467), on one
device.

The model's own float32 parameters are the master weights, updated in
place, and the optimizer keeps its f32 slots.  One step: with
``amp_dtype`` the forward runs on casts of the masters to that dtype,
swapped in for the model's parameters by `torch.func.functional_call`
(the JAX step's `bind_state` plus its O2 cast, :303-314), and floating
inputs enter in that dtype too (`_amp_in`).  Gradients reach the masters
through the cast, and a tied weight (GPT's `wte`, read by the embedding
and by the fused head) collects the gradient of every use; the loss
comes back as f32.  Then the optimizer applies its rule to the masters.
Buffers are not swapped: a batch norm in training mode updates the
model's own f32 running statistics in place during the forward, where
the JAX step threads them through as `new_buffers` (:327).

The rest of the JAX step is not ported: the multi-device half (ZeRO
stages, quantized collectives), its resilience hooks (guard, checkpoint
manager, preemption guard), gradient clipping and recompute.  Asking for
one raises NotImplementedError.  `run_steps` is a plain loop: the JAX
step's one-program scan has no counterpart yet.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

__all__ = ["DistributedTrainStep", "build_train_step"]

# keywords of the JAX step that the port accepts only at their off value
_UNPORTED = ("sharding_stage", "guard", "checkpoint_manager",
             "preemption_guard", "collective_precision", "grad_clip_norm",
             "recompute")


class _Objective(nn.Module):
    """The model and the loss as one module, so one functional_call
    swaps the parameters for both (the fused criterion reads the tied
    head weight through the model)."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, inputs, labels):
        return self.loss_fn(self.model(inputs), labels)


class DistributedTrainStep:
    """``step(inputs, labels)`` runs one optimizer step on
    ``loss_fn(model(inputs), labels)`` and returns the loss, an f32
    scalar on the model's device.  A model that returns its own loss
    (the JAX step's ``loss_fn=None``) is not ported."""

    def __init__(self, model, optimizer, loss_fn, amp_dtype=None,
                 **unported):
        for key, value in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"DistributedTrainStep got an unexpected "
                                f"keyword argument {key!r}")
            if value not in (None, 0, False):
                raise NotImplementedError(
                    f"DistributedTrainStep({key}={value!r}) is not ported "
                    "yet (ROADMAP Queue A): the port's train step runs on "
                    "one device, unguarded and unclipped")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.amp_dtype = getattr(torch, amp_dtype) \
            if isinstance(amp_dtype, str) else amp_dtype
        self._objective = _Objective(model, loss_fn)
        self._params = dict(model.named_parameters())
        low = sorted(n for n, p in self._params.items()
                     if p.dtype != torch.float32)
        if low:
            raise TypeError(f"the train step keeps float32 master weights; "
                            f"{low[:3]} are not float32 (build the model "
                            "in float32 and pass amp_dtype)")
        self._device = next(iter(self._params.values())).device
        self._state = optimizer.init_state(self._params)

    def _place(self, batch):
        """Batch leaves (images or token ids, labels) onto the model's
        device.  Under `amp_dtype` a floating leaf enters in that dtype,
        an integer one (token ids, class labels) as it is: the JAX
        step's `_amp_in` (:308-313, O2 semantics: a conv or matmul
        meets its cast weight in one dtype)."""
        placed = []
        for b in batch:
            b = torch.as_tensor(b).to(self._device)
            if self.amp_dtype is not None and b.is_floating_point():
                b = b.to(self.amp_dtype)
            placed.append(b)
        return tuple(placed)

    def _step(self, batch):
        self.model.train()
        run = self._params
        if self.amp_dtype is not None:
            run = {n: p.to(self.amp_dtype) for n, p in run.items()}
        loss = functional_call(self._objective,
                               {"model." + n: v for n, v in run.items()},
                               batch)
        loss = loss.float()
        if loss.dim():
            loss = loss.mean()
        # a parameter the forward does not read (a post-LN layer's unused
        # pre-LN scale) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, list(self._params.values()),
                                    allow_unused=True, materialize_grads=True)
        self.optimizer.apply_gradients(
            self._params, dict(zip(self._params, grads)), self._state)
        return loss.detach()

    def __call__(self, inputs, labels):
        return self._step(self._place((inputs, labels)))

    def run_steps(self, inputs, labels, repeat=None):
        """One step per leading-axis slice of `inputs` / `labels` (shaped
        [n_steps, ...]), or, with `repeat`, `repeat` steps on one batch.
        Returns the per-step losses, f32 [n_steps]."""
        placed = self._place((inputs, labels))
        if repeat is None:
            steps = [tuple(b[i] for b in placed)
                     for i in range(placed[0].shape[0])]
        else:
            if int(repeat) < 1:
                raise ValueError(f"repeat must be >= 1, got {repeat}")
            steps = [placed] * int(repeat)
        return torch.stack([self._step(b) for b in steps])


def build_train_step(model, optimizer, loss_fn, amp_dtype=None, **kw):
    """The train step of `model` (``fleet`` `DistributedModelProxy.
    build_train_step`, ``paddle_tpu/distributed/fleet/__init__.py:157``
    counterpart)."""
    return DistributedTrainStep(model, optimizer, loss_fn,
                                amp_dtype=amp_dtype, **kw)
