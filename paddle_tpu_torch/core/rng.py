"""Random state of the port (``paddle_tpu/core/rng.py`` counterpart:
`Generator` :15, `default_generator` :56, `seed` :107, `get_rng_state` /
`set_rng_state` :112-117).

The JAX package keeps one functional PRNG key behind a stateful facade
and threads it through its compiled programs.  Here each device has its
own `torch.Generator`, made at its first use and seeded with the last
`seed(n)` (0 until one is called); dropout draws from the generator of
its tensor's device.  `seed(n)` reseeds every generator made so far and
those made later, so a run is reproducible from one call.

Under a CUDA graph a generator replays the Philox offsets it was
captured with unless the graph knows it: the train step passes the
generator of its device to `core.graphs.Graph`, which registers it with
the capture (`CUDAGraph.register_generator_state`), so every replay
draws the next offsets and advances the generator as the eager body
would.  A generator not registered with a graph that draws from it
fails the capture.

`drawing_from(gen)` makes `generator(gen.device)` return `gen` on this
thread for the duration of a block: the replay of a recomputed block
draws its dropout masks from a generator placed where the block's
forward drew (`distributed/recompute.py`).
"""
from __future__ import annotations

import contextlib
import threading

import torch

_GENERATORS: dict = {}    # torch.device -> torch.Generator
_SEED = 0
_DRAWING = threading.local()   # this thread's `drawing_from` generator


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device) -> torch.Generator:
    """The dropout generator of `device`, made (and seeded) at first
    use."""
    key = _key(device)
    held = getattr(_DRAWING, "gen", None)
    if held is not None and _key(held.device) == key:
        return held
    gen = _GENERATORS.get(key)
    if gen is None:
        gen = torch.Generator(device=key)
        gen.manual_seed(_SEED)
        _GENERATORS[key] = gen
    return gen


def seed(n) -> None:
    """Seed every device's generator with `n`, now and at first use."""
    global _SEED
    _SEED = int(n)
    for gen in _GENERATORS.values():
        gen.manual_seed(_SEED)


def get_rng_state(device) -> torch.Tensor:
    """The state of `device`'s generator (a CPU byte tensor)."""
    return generator(device).get_state()


def set_rng_state(state, device) -> None:
    generator(device).set_state(state)


@contextlib.contextmanager
def drawing_from(gen):
    """Inside the block, on this thread, `generator(gen.device)` is
    `gen`."""
    prev = getattr(_DRAWING, "gen", None)
    _DRAWING.gen = gen
    try:
        yield gen
    finally:
        _DRAWING.gen = prev
