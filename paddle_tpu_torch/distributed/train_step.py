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

Recompute is the model's option (``GPTConfig(recompute=...)``,
`distributed.recompute`); ``recompute=`` here is taken and, as in the
JAX step, changes nothing.  A recomputed block's replay draws its
dropout from a generator of the step's `ReplayGenerators`, placed
before every graph replay where the device generator stands plus the
block's offset in the eager run the graph was captured after; those
generators are registered with the graph too.

``guard`` (True or a `resilience.StepGuard`; JAX :174-182, :407-419):
one finiteness reduction over the loss and every gradient on the
device, ``ok``.  The optimizer updates in place, so the body first
copies the parameters, the slots, the step and the buffers into
persistent backup tensors (one more copy of the parameters and slots
in device memory), and after the update selects ``where(ok, new,
backup)`` into the live tensors: a bad step keeps them all, and a
fault-free guarded step equals the unguarded one bit for bit.  The
host reads one ``ok`` a `__call__` and one [n_steps] vector a
`run_steps`, and feeds `guard.observe`, whose rollback restores the
newest good checkpoint through the attached `CheckpointManager`.
With ``guard=None`` the body has none of these ops.

The ``train.step`` fault point (JAX `_maybe_poison` :608): kind
"error" raises at dispatch; kind "nan" poisons the first floating
batch leaf, as JAX does, and in a guarded step also multiplies the loss
by a device flag set to NaN for that dispatch (1 otherwise), so a
token-id batch goes non-finite too and the replayed graph sees it with
no new capture.

Exact resume (JAX :64-116, :666-806): `train_state_dict` holds the
live tensors under the JAX keys (``param.<name>``,
``slot.<slot>.<name>``, ``opt.step``, ``buffer.<name>``) in the dtypes
JAX writes them in (f32, int32 for the step); `save_train_state` /
`load_train_state` write and read them in the JAX package's checkpoint
format (`distributed.checkpoint`) with the LR scheduler's sidecar, and
`attach_checkpoint_manager`, `save_checkpoint` and `rollback` go
through a `CheckpointManager`.  Loading copies into the live tensors,
so the graphs keep replaying.  As in JAX (:675-676), the dropout
generator is not part of that state: a resumed run with dropout draws
other masks than the run that saved, unless the caller saves and
restores `generator.get_state()` alongside.  Preemption (JAX
:727-772): the attached `PreemptionGuard` is checked before and after
each dispatch; a trip writes an emergency checkpoint through the
manager and raises `TrainingPreempted`, then the same exception again
on every later call, without saving again.

The multi-device half of the JAX step (ZeRO stages, quantized
collectives) is not ported: asking for it raises NotImplementedError.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module

from ..core import graphs as GR
from ..core import rng
from ..nn.clip import global_norm_scale, global_norm_sq
from ..optimizer.lr import LRScheduler
from ..resilience import faults as _faults
from ..resilience import guards as _guards
from .recompute import ReplayGenerators

__all__ = ["DistributedTrainStep", "build_train_step",
           "save_train_checkpoint", "load_train_checkpoint"]

_LR_SIDECAR = "lr_scheduler.json"

# keywords of the JAX step that the port accepts only at their off value
_UNPORTED = ("sharding_stage", "collective_precision")


def save_train_checkpoint(tensors, path, lr_sched=None):
    """Shared writer for both training tiers (hybrid step + pipeline):
    distributed checkpoint of the flat leaf dict, plus a host-side LR
    scheduler sidecar JSON when one is attached."""
    import json as _json
    import os as _os

    from ..optimizer.lr import LRScheduler
    from .checkpoint import save_state_dict

    save_state_dict(tensors, path)
    if isinstance(lr_sched, LRScheduler):
        with open(_os.path.join(path, _LR_SIDECAR), "w") as f:
            _json.dump(lr_sched.state_dict(), f)


def load_train_checkpoint(tensors, path, lr_sched=None):
    """Shared strict loader: every leaf in `tensors` must exist in the
    checkpoint (a partial match would silently mix loaded and fresh
    state), and when the caller trains under an LRScheduler its sidecar
    must be present too (restoring the step counter but restarting the
    warmup/decay schedule is the same silent divergence). Loads in place
    (each leaf copied into its target tensor)."""
    import json as _json
    import os as _os

    from ..optimizer.lr import LRScheduler
    from .checkpoint import load_state_dict
    from .checkpoint.api import _load_metadata

    meta = _load_metadata(path)
    if meta is None:
        raise ValueError(f"no checkpoint metadata found under {path!r}")
    missing = sorted(set(tensors) - set(meta.state_dict_metadata))
    if missing:
        raise ValueError(
            f"checkpoint at {path!r} is missing {len(missing)} of "
            f"{len(tensors)} training-state leaves (first: "
            f"{missing[:5]}) — refusing a partial resume (wrong model "
            "config or corrupt checkpoint?)")
    sched_file = _os.path.join(path, _LR_SIDECAR)
    if isinstance(lr_sched, LRScheduler):
        if not _os.path.exists(sched_file):
            raise ValueError(
                f"checkpoint at {path!r} has no {_LR_SIDECAR} but this "
                "run trains under an LRScheduler — resuming would "
                "restart the schedule at step 0 (was the checkpoint "
                "saved with a float learning rate?)")
        with open(sched_file) as f:
            state = _json.load(f)
    load_state_dict(tensors, path)
    if isinstance(lr_sched, LRScheduler):
        lr_sched.set_state_dict(state)


def _swapped(module, tensors):
    """`module` computing with `tensors` (name -> tensor) in place of its
    own parameters inside the block: what `torch.func.functional_call`
    does for one call, held open here for the backward too (tied
    weights stay tied)."""
    return _reparametrize_module(module, tensors, tie_weights=True)


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
                 grad_clip_norm=None, recompute=False, guard=None,
                 checkpoint_manager=None, preemption_guard=None,
                 **unported):
        for key, value in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"DistributedTrainStep got an unexpected "
                                f"keyword argument {key!r}")
            if value not in (None, 0, False):
                raise NotImplementedError(
                    f"DistributedTrainStep({key}={value!r}) is not ported "
                    "yet (ROADMAP Queue A7): the port's train step runs on "
                    "one device")
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
        self._replay_gens = ReplayGenerators(self._device)
        self._state = optimizer.init_state(self._params)
        self._lr = torch.zeros((), dtype=torch.float32, device=self._device)
        self._graphs = {}     # batch signature -> (static batch, Graph)
        self._offsets = {}    # batch signature -> its replay offsets
        self._bound = None    # the state's addresses the graphs hold
        # --- resilience ---
        if guard is True:
            guard = _guards.StepGuard(name="train_step")
        self.guard = guard or None
        self._ok = self._poison = self._backup = None
        if self.guard is not None:
            # written by the body; a graph writes into them on replay
            self._ok = torch.ones((), dtype=torch.bool, device=self._device)
            self._poison = torch.ones((), dtype=torch.float32,
                                      device=self._device)
        self._ckpt_mgr = checkpoint_manager
        if self.guard is not None and self._ckpt_mgr is not None \
                and self.guard.on_rollback is None:
            self.guard.set_rollback(self.rollback)
        self._preemption_guard = preemption_guard
        self._preemption_handled = None  # TrainingPreempted once raised

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

    def _buffers(self) -> dict:
        """The model's persistent buffers by name (JAX
        ``functional_state()``'s second dict)."""
        state = self.model.state_dict(keep_vars=True)
        return {n: b for n, b in self.model.named_buffers() if n in state}

    def _guarded_tensors(self) -> list:
        """What a bad step must leave as it was: the masters, the
        optimizer's slots and step, the buffers (the loss's too)."""
        ts = list(self._params.values())
        for slots in self._state["slots"].values():
            ts.extend(slots.values())
        ts.append(self._state["step"])
        ts.extend(self._objective.buffers())
        return ts

    def _backed_up(self, live):
        """The backup tensors of `live`, made at the first guarded step
        (and again if the state was rebound), filled with `live`."""
        bk = self._backup
        if bk is None or len(bk) != len(live) or any(
                b.shape != t.shape or b.dtype != t.dtype
                for b, t in zip(bk, live)):
            bk = self._backup = [torch.empty_like(t) for t in live]
        torch._foreach_copy_(bk, live)
        return bk

    def _step(self, batch):
        """The body: one optimizer step on `batch`; the loss, f32."""
        self.model.train()
        guarded = self.guard is not None
        if guarded:
            live = self._guarded_tensors()
            backup = self._backed_up(live)
        run = self._params
        if self.amp_dtype is not None:
            run = {n: p.to(self.amp_dtype) for n, p in run.items()}
        # the backward runs under the swapped parameters too: a
        # recomputed block replays its forward there
        with _swapped(self._objective,
                      {"model." + n: v for n, v in run.items()}), \
                self._replay_gens.running():
            loss = self._objective(*batch).float()
            if loss.dim():
                loss = loss.mean()
            if guarded:
                loss = loss * self._poison     # 1, or NaN for a fault
            # a parameter the forward does not read (a post-LN layer's
            # unused pre-LN scale) gets a zero gradient, as jax.grad
            # gives it
            grads = torch.autograd.grad(loss, list(self._params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        if self.grad_clip_norm is not None:
            # out of place: autograd may hand two parameters one tensor
            grads = torch._foreach_mul(grads, global_norm_scale(
                global_norm_sq(grads), self.grad_clip_norm))
        if guarded:
            ok = _guards.tree_finite(loss, grads)
            self._ok.copy_(ok)
        self.optimizer.apply_gradients(
            self._params, dict(zip(self._params, grads)), self._state,
            lr=self._lr)
        if guarded:
            with torch.no_grad():
                for t, b in zip(live, backup):
                    torch.where(ok, t, b, out=t)
        return loss.detach()

    def __call__(self, *batch):
        """One step; the loss.  A guarded step reads its ``ok`` back and
        feeds the guard."""
        self._check_preemption()                 # safe point: pre-dispatch
        placed = self._maybe_poison(self._place(batch))
        losses = self._dispatch([placed], [self.optimizer.get_lr()])
        self._check_preemption()                 # safe point: post-step
        return losses[0]

    def run_steps(self, *batch, lrs=None, repeat=None):
        """One step per leading-axis slice of the batch leaves (each
        shaped [n_steps, ...]), or, with `repeat`, `repeat` steps on one
        batch.  `lrs`: the rate of each step, [n_steps]; by default the
        scheduler's next rates (the scheduler steps once a step) or the
        optimizer's fixed rate.  Returns the per-step losses, f32
        [n_steps]."""
        self._check_preemption()       # don't start steps we can't keep
        if repeat is not None and int(repeat) < 1:
            raise ValueError(f"repeat must be >= 1, got {repeat}")
        placed = self._place(batch)
        n = int(repeat) if repeat is not None else placed[0].shape[0]
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
        placed = self._maybe_poison(placed, n_steps=n)
        if repeat is None:
            steps = [tuple(b[i] for b in placed) for i in range(n)]
        else:
            steps = [placed] * n
        losses = self._dispatch(steps, lrs)
        self._check_preemption()       # signal landed mid-run: save now
        return losses

    def _maybe_poison(self, placed, n_steps=1):
        """The ``train.step`` fault point, once a dispatch: kind "error"
        raises here; kind "nan" poisons the first floating leaf (JAX
        :608-625) and, in a guarded step, sets the loss flag to NaN
        for this dispatch."""
        action = _faults.fire("train.step", n_steps=n_steps)
        if action is None or action.kind != "nan":
            return placed
        placed = list(placed)
        for i, b in enumerate(placed):
            if b.is_floating_point():
                # 0 * nan propagates NaN elementwise
                placed[i] = b + float("nan") * torch.zeros_like(b)
                break
        if self._poison is not None:
            self._poison.fill_(float("nan"))
        return tuple(placed)

    def _dispatch(self, batches, lrs):
        """`_run`, then for a guarded step the one host read of the
        steps' ok flags, fed to the guard; the poison flag is cleared
        whatever happens."""
        oks = None if self.guard is None else torch.ones(
            len(batches), dtype=torch.bool, device=self._device)
        try:
            losses = self._run(batches, lrs, oks)
        finally:
            if self._poison is not None:
                self._poison.fill_(1.0)
        if oks is not None:
            for ok in oks.tolist():
                self.guard.observe(bool(ok))
        return losses

    def _run(self, batches, lrs, oks=None):
        """One step per placed batch, at the rates `lrs` (floats); the
        losses, f32 [len(batches)].  `oks`: where each step's ok flag
        goes (a guarded step)."""
        if self._device.type == "cpu":
            return torch.stack([self._step(b)
                                for b in self._at_rates(batches, lrs, oks)])
        return self._replay(batches, lrs, oks)

    def _at_rates(self, batches, lrs, oks=None):
        """`batches`, each yielded once the device rate holds its step's
        rate (an asynchronous fill, no host sync); with `oks`, the ok
        flag of each step, once it has run, copied into its entry."""
        for i, (batch, lr) in enumerate(zip(batches, lrs)):
            self._lr.fill_(lr)
            yield batch
            if oks is not None:
                oks[i] = self._ok

    def _state_tensors(self) -> list:
        """Every tensor the step reads or updates in place besides its
        batch: the masters, the optimizer's slots and step, the learning
        rate, the model's (and the loss's) buffers, and in a guarded
        step its flags and backups."""
        ts = list(self._params.values())
        for slots in self._state["slots"].values():
            ts.extend(slots.values())
        ts += [self._state["step"], self._lr]
        ts.extend(self._objective.buffers())
        if self.guard is not None:
            ts += [self._ok, self._poison] + list(self._backup or ())
        return ts

    def _replay(self, batches, lrs, oks=None):
        """The CUDA path of `_run`: each batch's signature's graph
        replayed, captured after an eager first step of the signature.
        `oks`: where each step's ok flag goes (a guarded step)."""
        losses = torch.empty(len(batches), dtype=torch.float32,
                             device=self._device)
        if GR.addresses(self._state_tensors()) != self._bound:
            self._graphs.clear()
        loaded = None
        gens = self._replay_gens
        for i, batch in enumerate(self._at_rates(batches, lrs, oks)):
            key = tuple((b.shape, b.dtype) for b in batch)
            if key not in self._graphs:
                static = tuple(torch.empty_like(b) for b in batch)
                for dst, src in zip(static, batch):
                    dst.copy_(src)
                body = functools.partial(self._step, static)
                stream = GR.capture_stream(self._device)
                # the replay generators the warm-up made are registered
                # with the graph too
                losses[i], graph = GR.capture(
                    body, stream, "train_step",
                    generators=lambda: (self.generator, *gens.generators))
                # the first step may turn an int step into a tensor, and
                # a guarded one makes its backups: graphs captured
                # before it hold other addresses
                bound = GR.addresses(self._state_tensors())
                if bound != self._bound:
                    self._graphs.clear()
                    self._bound = bound
                self._graphs[key] = (static, graph)
                self._offsets[key] = list(gens.offsets)
                loaded = batch
            else:
                static, graph = self._graphs[key]
                if batch is not loaded:          # `repeat`: one copy
                    for dst, src in zip(static, batch):
                        dst.copy_(src)
                    loaded = batch
                if gens.generators:
                    gens.place(self._offsets[key])
                graph.replay()
                losses[i] = graph.outputs
        return losses

    # --- exact training resume ----------------------------------------------
    def train_state_dict(self) -> dict:
        """The complete resumable state as a flat dict of the live
        tensors under the JAX step's keys (:666): ``param.<name>``,
        ``slot.<slot>.<name>``, ``opt.step``, ``buffer.<name>``.  The
        dropout generator is not in it (JAX :675-676)."""
        out = {f"param.{n}": p for n, p in self._params.items()}
        for n, slots in self._state["slots"].items():
            for k, v in slots.items():
                out[f"slot.{k}.{n}"] = v
        out["opt.step"] = self._state["step"]
        for n, b in self._buffers().items():
            out[f"buffer.{n}"] = b
        return out

    def save_train_state(self, path):
        """The whole training state in the JAX package's checkpoint
        format, with the LR scheduler's position beside it (JAX
        :691)."""
        save_train_checkpoint(self.train_state_dict(), path,
                              self.optimizer._learning_rate)

    def load_train_state(self, path):
        """Resume exactly from a `save_train_state` checkpoint of either
        package: every leaf of this step's state must be in it, and the
        scheduler's sidecar when one drives the rate (JAX :700).  The
        leaves are copied into the live tensors."""
        load_train_checkpoint(self.train_state_dict(), path,
                              self.optimizer._learning_rate)

    # --- resilience: preemption safe points ----------------------------------
    def attach_preemption_guard(self, guard):
        """Consult `guard` (a `resilience.PreemptionGuard`) at this
        step's safe points (JAX :727)."""
        self._preemption_guard = guard
        return self

    def _check_preemption(self):
        """Safe point, between dispatches: the live state is a whole
        post-step state here, which the emergency checkpoint saves (JAX
        :734).  A second call after a trip raises the same exception
        without saving again."""
        g = self._preemption_guard
        if g is None or not g.check():
            return
        if self._preemption_handled is not None:
            raise self._preemption_handled
        from ..resilience.preemption import TrainingPreempted

        ckpt_dir = step_no = None
        if self._ckpt_mgr is not None:
            step_no = int(self._state["step"])
            ckpt_dir = self.save_checkpoint(step=step_no)
            try:
                from ..observability import flight as _flight
                from ..observability import metrics as _metrics

                _metrics.inc("preemption.checkpoints")
                _flight.record("preemption.checkpoint_saved",
                               path=ckpt_dir, step=step_no,
                               reason=g.reason)
            except Exception:  # pt-lint: ok[PT005]
                pass           # (the checkpoint landed; telemetry must
                # not turn a clean preemption exit into a crash)
        exit_code = getattr(g, "exit_code", 0)
        self._preemption_handled = TrainingPreempted(
            g.reason, checkpoint_dir=ckpt_dir, step=step_no,
            exit_code=exit_code)
        raise self._preemption_handled

    # --- resilience: rotation checkpointing + guard rollback -----------------
    def attach_checkpoint_manager(self, manager):
        """Use a `distributed.checkpoint.CheckpointManager` as this
        step's save target and, with a guard that has no rollback of its
        own, the guard's rollback source (JAX :775)."""
        self._ckpt_mgr = manager
        if self.guard is not None and self.guard.on_rollback is None:
            self.guard.set_rollback(self.rollback)
        return self

    def save_checkpoint(self, step=None, async_save=False):
        """The whole training state through the attached manager (atomic,
        CRC'd, rotated); returns the checkpoint's directory (JAX
        :784)."""
        if self._ckpt_mgr is None:
            raise ValueError("no CheckpointManager attached "
                             "(attach_checkpoint_manager first)")
        return self._ckpt_mgr.save(self.train_state_dict(), step=step,
                                   async_save=async_save)

    def rollback(self):
        """Restore the newest checkpoint that verifies from the attached
        manager into the live state (corrupt ones are quarantined);
        returns the step restored (JAX :793)."""
        if self._ckpt_mgr is None:
            raise ValueError("no CheckpointManager attached "
                             "(attach_checkpoint_manager first)")
        return self._ckpt_mgr.restore(self.train_state_dict())


def build_train_step(model, optimizer, loss_fn=None, amp_dtype=None,
                     **kw):
    """The train step of `model` (``fleet`` `DistributedModelProxy.
    build_train_step`, ``paddle_tpu/distributed/fleet/__init__.py:157``
    counterpart)."""
    return DistributedTrainStep(model, optimizer, loss_fn,
                                amp_dtype=amp_dtype, **kw)
