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

The JAX step is one compiled program (`jax.jit` with donated state,
:429), and `run_steps` one `lax.scan` of it (:433-467).  Here, on a CUDA
device, the step is a CUDA graph (`core.graphs`), one per batch
signature (the shapes and dtypes of the placed leaves): the first step
of a signature runs the body eagerly on a side stream, as a real step
whose loss it returns, and is followed by the capture; every later step
copies its batch into the graph's static batch tensors and replays it.
`run_steps` replays once a step and gathers the losses into one [n_steps]
tensor.  The learning rate is a device tensor that each call refills
from the optimizer (the JAX step passes ``get_lr()`` in), and the
optimizer's step count lives on the device, so a replay computes what
the eager body computes.  A graph holds the addresses of the parameters,
the optimizer state and the model's buffers: loading a state must copy
into them (`load_state_dict` and `load_reference_state` do), and a
tensor rebound or reshaped drops every graph, so the next step captures
again rather than replay stale addresses.  On the CPU every step runs
the body.

With ``grad_clip_norm`` the gradients are scaled by ``min(1, c /
max(sqrt(gsq), 1e-6))`` before the update, gsq their sum of squares in
f32 (JAX :368-375), all on the device: a graph replays it with no host
sync.  With ``loss_fn=None`` the model returns its own loss from
``model(*batch)`` (JAX :325-326), and `__call__` / `run_steps` take the
batch as any number of leaves.  `run_steps(..., lrs=)` gives each step
its own rate; without `lrs` a scheduler-driven optimizer hands over its
next rates, stepping the scheduler once a step, as the JAX `run_steps`
does (:496-506), while `__call__` reads `get_lr()` and leaves stepping
the scheduler to the caller.  Dropout draws from the device's generator
(`core.rng`), which every graph of the step registers, so each replay
draws new masks and advances it as the eager body would; a replay equals
the body run from the same generator state bit for bit.  The generator
is not one of `_state_tensors` (its state is not a tensor that `copy_`
restores): `generator.get_state()` / `set_state()` save and restore it.

The rest of the JAX step is not ported: the multi-device half (ZeRO
stages, quantized collectives), its resilience hooks (guard, checkpoint
manager, preemption guard) and recompute.  Asking for one raises
NotImplementedError.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.func import functional_call

from ..core import graphs as GR
from ..core import rng
from ..nn.clip import global_norm_scale, global_norm_sq
from ..optimizer.lr import LRScheduler

__all__ = ["DistributedTrainStep", "build_train_step"]

# keywords of the JAX step that the port accepts only at their off value
_UNPORTED = ("sharding_stage", "guard", "checkpoint_manager",
             "preemption_guard", "collective_precision", "recompute")


class _Objective(nn.Module):
    """The model and the loss as one module, so one functional_call
    swaps the parameters for both (the fused criterion reads the tied
    head weight through the model).  Without a loss the model's own
    output is the loss."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *batch):
        if self.loss_fn is None:
            return self.model(*batch)
        inputs, labels = batch
        return self.loss_fn(self.model(inputs), labels)


class DistributedTrainStep:
    """``step(inputs, labels)`` runs one optimizer step on
    ``loss_fn(model(inputs), labels)``, or with ``loss_fn=None``
    ``step(*batch)`` one on ``model(*batch)``, and returns the loss, an
    f32 scalar on the model's device."""

    def __init__(self, model, optimizer, loss_fn=None, amp_dtype=None,
                 grad_clip_norm=None, **unported):
        for key, value in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"DistributedTrainStep got an unexpected "
                                f"keyword argument {key!r}")
            if value not in (None, 0, False):
                raise NotImplementedError(
                    f"DistributedTrainStep({key}={value!r}) is not ported "
                    "yet (ROADMAP Queue A): the port's train step runs on "
                    "one device, unguarded, without recompute")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_clip_norm = None if grad_clip_norm is None \
            else float(grad_clip_norm)
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
        self.generator = rng.generator(self._device)
        self._state = optimizer.init_state(self._params)
        self._lr = torch.zeros((), dtype=torch.float32, device=self._device)
        self._graphs = {}     # batch signature -> (static batch, Graph)
        self._bound = None    # the state's addresses the graphs hold

    def _place(self, batch):
        """Batch leaves (images or token ids, labels, ...) onto the model's
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
        """The body: one optimizer step on `batch`; the loss, f32."""
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
        if self.grad_clip_norm is not None:
            # out of place: autograd may hand two parameters one tensor
            grads = torch._foreach_mul(grads, global_norm_scale(
                global_norm_sq(grads), self.grad_clip_norm))
        self.optimizer.apply_gradients(
            self._params, dict(zip(self._params, grads)), self._state,
            lr=self._lr)
        return loss.detach()

    def __call__(self, *batch):
        return self._run([self._place(batch)],
                         [self.optimizer.get_lr()])[0]

    def run_steps(self, *batch, lrs=None, repeat=None):
        """One step per leading-axis slice of the batch leaves (each
        shaped [n_steps, ...]), or, with `repeat`, `repeat` steps on one
        batch.  `lrs`: the rate of each step, [n_steps]; by default the
        scheduler's next rates (the scheduler steps once a step) or the
        optimizer's fixed rate.  Returns the per-step losses, f32
        [n_steps]."""
        placed = self._place(batch)
        if repeat is None:
            steps = [tuple(b[i] for b in placed)
                     for i in range(placed[0].shape[0])]
        else:
            if int(repeat) < 1:
                raise ValueError(f"repeat must be >= 1, got {repeat}")
            steps = [placed] * int(repeat)
        n = len(steps)
        if lrs is None:
            sched = self.optimizer._learning_rate
            lrs = []
            for _ in range(n):
                lrs.append(self.optimizer.get_lr())
                if isinstance(sched, LRScheduler):
                    sched.step()
        else:
            lrs = torch.as_tensor(lrs, dtype=torch.float32)
            if tuple(lrs.shape) != (n,):
                raise ValueError(f"lrs must have shape ({n},), got "
                                 f"{tuple(lrs.shape)}")
            lrs = lrs.tolist()
        return self._run(steps, lrs)

    def _run(self, batches, lrs):
        """One step per placed batch, at the rates `lrs` (floats); the
        losses, f32 [len(batches)]."""
        if self._device.type == "cpu":
            return torch.stack([self._step(b)
                                for b in self._at_rates(batches, lrs)])
        return self._replay(batches, lrs)

    def _at_rates(self, batches, lrs):
        """`batches`, each yielded once the device rate holds its step's
        rate (an asynchronous fill, no host sync)."""
        for batch, lr in zip(batches, lrs):
            self._lr.fill_(lr)
            yield batch

    def _state_tensors(self) -> list:
        """Every tensor the step reads or updates in place besides its
        batch: the masters, the optimizer's slots and step, the learning
        rate, the model's (and the loss's) buffers."""
        ts = list(self._params.values())
        for slots in self._state["slots"].values():
            ts.extend(slots.values())
        ts += [self._state["step"], self._lr]
        ts.extend(self._objective.buffers())
        return ts

    def _replay(self, batches, lrs):
        """The CUDA path of `_run`: each batch's signature's graph
        replayed, captured after an eager first step of the signature."""
        losses = torch.empty(len(batches), dtype=torch.float32,
                             device=self._device)
        if GR.addresses(self._state_tensors()) != self._bound:
            self._graphs.clear()
        loaded = None
        for i, batch in enumerate(self._at_rates(batches, lrs)):
            key = tuple((b.shape, b.dtype) for b in batch)
            if key not in self._graphs:
                static = tuple(torch.empty_like(b) for b in batch)
                for dst, src in zip(static, batch):
                    dst.copy_(src)
                body = functools.partial(self._step, static)
                stream = GR.capture_stream(self._device)
                losses[i], graph = GR.capture(
                    body, stream, "train_step", generators=(self.generator,))
                # the first step may turn an int step into a tensor:
                # graphs captured before it hold other addresses
                bound = GR.addresses(self._state_tensors())
                if bound != self._bound:
                    self._graphs.clear()
                    self._bound = bound
                self._graphs[key] = (static, graph)
                loaded = batch
                continue
            static, graph = self._graphs[key]
            if batch is not loaded:          # `repeat`: one copy
                for dst, src in zip(static, batch):
                    dst.copy_(src)
                loaded = batch
            graph.replay()
            losses[i] = graph.outputs
        return losses


def build_train_step(model, optimizer, loss_fn=None, amp_dtype=None,
                     **kw):
    """The train step of `model` (``fleet`` `DistributedModelProxy.
    build_train_step`, ``paddle_tpu/distributed/fleet/__init__.py:157``
    counterpart)."""
    return DistributedTrainStep(model, optimizer, loss_fn,
                                amp_dtype=amp_dtype, **kw)
