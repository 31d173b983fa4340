"""CUDA graphs: the port's counterpart of the compiled fixed-shape
programs of the JAX package (`jax.jit` with donated buffers: the
engine's `_decode_program`, the train step and its `run_steps` scan).

Such a program is a body that reads and writes tensors at fixed
addresses only: its inputs are copied into static tensors it owns, its
state (page pools, parameters, optimizer slots) is updated in place, and
its results land in tensors it owns.  On a CUDA device the body runs
eagerly once on a side stream (`warm_up`: the kernels build at first use
and set their launch attributes there), is then captured into one
`torch.cuda.CUDAGraph` on that stream (`Graph`), and every later run
replays the graph.  On the CPU the caller runs the body itself.

`capture` runs both steps of one program under its label and times
them (`observability.capture_cost`: the lifecycle ledger's compile
record of the JAX program whose role the graph takes).

A capture that fails raises; nothing here falls back to the eager body.
The kernels launch on torch's current stream (`ops/kernels/_build.py`,
`stream_ptr`), so a capture records them.  Their wrappers count a launch
when Python calls them, which a capture does once and a replay never
does, so `Graph` takes the capture's counts back off the counters and
adds them again on every replay.

Every capture and warm-up runs on one side stream per device and
thread (`capture_stream`): cuBLAS keeps a workspace for each stream it
ran on, for the life of the process, so a stream per capture would grow
the device memory with the number of captures.  It is per thread
because a capture is `thread_local`: two threads capturing on one
stream would fail each other's capture.

The graphs that one owner holds (an engine, one model's `generate()`,
one `StaticFunction`) share the owner's memory pool
(`torch.cuda.graph_pool_handle()`, passed as `Graph(..., pool=)`): the
pool then holds about the largest graph's temporaries, not the sum over
the graphs.  The rule that makes the sharing safe: a graph's
temporaries may overlap the outputs of a graph captured later in the
same pool, so the outputs of a graph are dead once another graph of the
pool replays.  An owner's programs therefore write their results into
static tensors allocated outside the capture, or their caller clones or
consumes a result before the next replay of any graph of the pool.
"""
from __future__ import annotations

import gc
import threading

import torch

from ..observability import capture_cost as CC
from ..ops import kernels as K

# cudaStreamCaptureModeThreadLocal: only this thread's unsafe calls (a
# synchronous copy, an allocation outside the graph's pool) fail the
# capture.  The engine captures on its loop thread while other threads
# of the process (the caller's, a server's) may use the device, and in
# the "global" mode their calls would fail a capture they have no part
# in.  The autograd engine's device thread, which enqueues the train
# step's backward onto the capturing stream, makes only calls that are
# legal under capture: launches, and allocations the caching allocator
# routes into the graph's pool.
CAPTURE_MODE = "thread_local"


_THREAD = threading.local()


def capture_stream(device) -> "torch.cuda.Stream":
    """This thread's side stream on CUDA `device`, made at its first use;
    every capture and warm-up of the thread runs on it."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    streams = _THREAD.__dict__.setdefault("streams", {})
    if index not in streams:
        streams[index] = torch.cuda.Stream(index)
    return streams[index]


def warm_up(body, stream):
    """Run `body()` eagerly on `stream`, after the current stream's work
    and before its later work; returns what `body` returns, once the
    body has run on the device (so the wall time of a call is the
    warm-up's, kernel builds included)."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = body()
    cur.wait_stream(stream)
    stream.synchronize()
    return out


def capture(body, stream, label, pool=None, generators=()):
    """`warm_up(body, stream)`, then `Graph(body, stream, pool,
    generators)`, timed under `label` (`capture_cost`).  `generators`
    may be a callable, called after the warm-up (a body whose warm-up
    makes generators, as a train step's recomputed blocks do).  Returns
    what the warm-up's body returned and the graph.  A failure in
    either step raises and records nothing."""
    with CC.CaptureTiming(label) as timing:
        out = warm_up(body, stream)
        timing.warmed()
        if callable(generators):
            generators = generators()
        graph = Graph(body, stream, pool=pool, generators=generators)
    return out, graph


def addresses(tensors) -> tuple:
    """What a graph holds of `tensors`: each one's address, shape and
    dtype (a value that is not a tensor stands for itself).  A graph
    replays the addresses it captured, so a program whose tensors no
    longer match must capture again or raise."""
    return tuple((t.data_ptr(), t.shape, t.dtype)
                 if isinstance(t, torch.Tensor) else t for t in tensors)


class _CollectorPaused:
    """Python's cyclic garbage collector off for the duration of a
    capture.  A collection inside it could free an unreachable owner's
    CUDA graph (an engine dropped with a reference cycle, say), and
    destroying a graph is a call that a capture on this thread does not
    permit: the capture fails.  `torch.cuda.graph` no longer collects on
    entry.  The collector's earlier state comes back at the end."""

    def __enter__(self):
        self.was = gc.isenabled()
        gc.disable()

    def __exit__(self, *exc):
        if self.was:
            gc.enable()
        return False


class Graph:
    """`body` captured into one CUDA graph on `stream`, the stream it was
    warmed up on, in the memory pool `pool` (a private pool when None).
    `outputs` is what `body` returned during the capture: tensors in the
    graph's memory pool that every replay rewrites (and, in a shared
    pool, that the replay of another of its graphs may overwrite).
    `launches` maps each kernel to its launches in one replay.
    `generators`: the CUDA generators `body` draws from (`core.rng`),
    registered with the graph so that each replay draws the next Philox
    offsets and advances them, as running `body` would."""

    def __init__(self, body, stream, pool=None, generators=()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = K.launch_counts()
        with _CollectorPaused(), torch.cuda.graph(
                self.graph, pool=pool, stream=stream,
                capture_error_mode=CAPTURE_MODE):
            self.outputs = body()
        after = K.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        # the capture recorded these launches and ran none of them
        K.add_launches({k: -n for k, n in self.launches.items()})

    def replay(self) -> None:
        """Launch the graph on the current stream."""
        self.graph.replay()
        K.add_launches(self.launches)
