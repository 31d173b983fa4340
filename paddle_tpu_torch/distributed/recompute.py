"""Activation recompute (``paddle_tpu/distributed/recompute.py``
counterpart: `recompute` :44, `recompute_sequential` :70, the policies
`_POLICIES` :28).

The JAX package wraps the segment in `jax.checkpoint` under trace, and
XLA replays it in the backward.  Here the segment runs under
`torch.utils.checkpoint` (non-reentrant) whenever grad is enabled: the
forward keeps only the segment's inputs, and the backward runs the
segment again to rebuild what its gradient needs.  Outputs and
gradients equal the plain forward's.  The policies:

  * ``None`` / ``"full"``: replay the whole segment;
  * ``"dots"``: keep every matmul output (``aten.mm``, ``addmm``,
    ``bmm``, ``baddbmm``) and replay the rest;
  * ``"dots_no_batch"``: keep the matmul outputs that have no batch
    dimension (``mm``, ``addmm``: the projections, whose replay costs
    the most) and replay the batched ones.

A hand-written kernel is not a dot, as a ``pallas_call`` is not one
under JAX's ``checkpoint_dots``: the flash and rope kernels of a block
run again in its replay under every policy, and their launch counters
count both runs.  An unknown policy raises ValueError, with or without
grad (JAX :35-40).

Dropout inside a replayed segment.  The JAX package threads its PRNG
key, so the replay sees the forward's key.  The port's dropout draws
from its device's generator (`core.rng`), which
`torch.utils.checkpoint(preserve_rng_state=True)` does not restore.
Each recomputed call therefore gets a generator of its own, placed
where the device's generator stood when the segment's forward drew,
and its replay draws from that one (`core.rng.drawing_from`): the
masks are the forward's, and the device's generator is not advanced a
second time.  Eagerly (the CPU, or CUDA without a graph) that
placement is a state copy at the forward.  A CUDA graph's capture can
neither read nor set a generator's state, so inside a train step the
calls draw from `ReplayGenerators`: each generator is registered with
the step's graphs, and `ReplayGenerators.place` sets it, before every
replay, to the device generator's seed and offset plus the offset that
generator had advanced by at the same call in the eager warm-up of
the same body.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils import checkpoint as _checkpoint

from ..core import rng

__all__ = ["recompute", "recompute_sequential", "ReplayGenerators"]

_aten = torch.ops.aten
_POLICIES = {
    None: None,
    "full": None,
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}

_ACTIVE = threading.local()    # the ReplayGenerators of a running body


def _resolve_policy(name):
    if name not in _POLICIES:
        raise ValueError(
            f"recompute policy must be one of "
            f"{sorted(k for k in _POLICIES if k)} or None, got {name!r}")
    return _POLICIES[name]


def _context_fn(saved):
    """The selective-checkpoint contexts that keep the outputs of the
    ops in `saved` and replay every other op."""
    policy = _checkpoint.CheckpointPolicy

    def decide(ctx, func, *args, **kwargs):
        return policy.MUST_SAVE if func in saved \
            else policy.PREFER_RECOMPUTE

    return lambda: _checkpoint.create_selective_checkpoint_contexts(decide)


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class ReplayGenerators:
    """The generators the recomputed calls of one body (a train step's)
    replay their dropout from, the i-th call's i-th generator.

    `running()` wraps each run of the body.  Outside a capture each
    call's generator takes the device generator's state at the call's
    forward, and on CUDA the device generator's offset since the start
    of the run is kept (`offsets`).  Inside a capture nothing is read or
    set: `generators` must be registered with the graph, and `place`,
    given the offsets of the eager run the graph was captured after,
    sets each generator before every replay."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.generators = []
        self.offsets = []
        self._next = 0
        self._start = 0

    @contextlib.contextmanager
    def running(self):
        prev = getattr(_ACTIVE, "value", None)
        _ACTIVE.value = self
        self._next = 0
        if self.device.type == "cuda" and not _capturing(self.device):
            self._start = rng.generator(self.device).get_offset()
        try:
            yield self
        finally:
            _ACTIVE.value = prev

    def take(self):
        """The next call's generator, placed at the device generator's
        state outside a capture."""
        i = self._next
        self._next += 1
        if _capturing(self.device):
            if i >= len(self.generators):
                raise RuntimeError(
                    "a recomputed call that the eager run before the "
                    "capture did not make")
            return self.generators[i]
        if i == len(self.generators):
            self.generators.append(torch.Generator(device=self.device))
            self.offsets.append(0)
        main = rng.generator(self.device)
        self.generators[i].set_state(main.get_state())
        if self.device.type == "cuda":
            self.offsets[i] = main.get_offset() - self._start
        return self.generators[i]

    def place(self, offsets) -> None:
        """Before a replay: generator i at the device generator's seed
        and its offset plus ``offsets[i]`` (host calls only).  Nothing
        on the CPU, where the body runs eagerly every time."""
        if self.device.type != "cuda":
            return
        main = rng.generator(self.device)
        seed, start = main.initial_seed(), main.get_offset()
        for gen, off in zip(self.generators, offsets):
            gen.manual_seed(seed)
            gen.set_offset(start + off)


def _replay_generator(device):
    """The generator a recomputed call at `device` replays from: the
    running body's next one, or outside a body a fresh generator at the
    device generator's state (no state is read under a capture: a
    replay that draws from it fails the capture, as it should)."""
    active = getattr(_ACTIVE, "value", None)
    if active is not None and active.device == device:
        return active.take()
    gen = torch.Generator(device=device)
    if not _capturing(device):
        gen.set_state(rng.generator(device).get_state())
    return gen


def _device_of(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            dev = a.device
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            return dev
    return None


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              policy=None, **kwargs):
    """``function(*args, **kwargs)``, its activations rebuilt in the
    backward.  `use_reentrant` and `preserve_rng_state` are taken for
    the reference's signature: the port always checkpoints
    non-reentrantly, and places the dropout generator itself."""
    saved = _resolve_policy(policy)
    device = _device_of(args, kwargs)
    if not torch.is_grad_enabled() or device is None:
        return function(*args, **kwargs)
    replay = _replay_generator(device)
    runs = []

    def run(*a, **kw):
        runs.append(None)
        if len(runs) == 1:            # the forward
            return function(*a, **kw)
        with rng.drawing_from(replay):
            return function(*a, **kw)

    extra = {} if saved is None else {"context_fn": _context_fn(saved)}
    return _checkpoint.checkpoint(run, *args, use_reentrant=False,
                                  preserve_rng_state=False, **extra,
                                  **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute over a Sequential in ``ctx["segments"]`` chunks (JAX
    :70)."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    sublayers = list(functions) if isinstance(functions, (list, tuple)) \
        else list(functions.children())
    n = len(sublayers)
    seg = max(1, n // max(1, segments))
    out = args[0] if len(args) == 1 else args

    def run_segment(layers):
        def f(x):
            for layer in layers:
                x = layer(x)
            return x

        return f

    i = 0
    while i < n:
        out = recompute(run_segment(sublayers[i:i + seg]), out)
        i += seg
    return out
