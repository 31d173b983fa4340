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

A capture that fails raises; nothing here falls back to the eager body.
The kernels launch on torch's current stream (`ops/kernels/_build.py`,
`stream_ptr`), so a capture records them.  Their wrappers count a launch
when Python calls them, which a capture does once and a replay never
does, so `Graph` takes the capture's counts back off the counters and
adds them again on every replay.
"""
from __future__ import annotations

import torch

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


def warm_up(body, stream):
    """Run `body()` eagerly on `stream`, after the current stream's work
    and before its later work; returns what `body` returns."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = body()
    cur.wait_stream(stream)
    return out


def addresses(tensors) -> tuple:
    """What a graph holds of `tensors`: each one's address, shape and
    dtype (a value that is not a tensor stands for itself).  A graph
    replays the addresses it captured, so a program whose tensors no
    longer match must capture again or raise."""
    return tuple((t.data_ptr(), t.shape, t.dtype)
                 if isinstance(t, torch.Tensor) else t for t in tensors)


class Graph:
    """`body` captured into one CUDA graph on `stream`, the stream it was
    warmed up on.  `outputs` is what `body` returned during the capture:
    tensors in the graph's memory pool that every replay rewrites.
    `launches` maps each kernel to its launches in one replay."""

    def __init__(self, body, stream):
        self.graph = torch.cuda.CUDAGraph()
        before = K.launch_counts()
        with torch.cuda.graph(self.graph, stream=stream,
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
