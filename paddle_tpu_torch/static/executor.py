"""Static-graph Executor, forward programs (``paddle_tpu/static/
executor.py`` counterpart: `_replay` :25, `_backward_reach` :68, `_build`
:93, `Executor` :183, `_feeds_needed` :277, `scope_guard` :283,
`global_scope` :293).

`Executor.run(program, feed, fetch_list)` prunes the recorded ops to
those that reach the fetches and replays them on the fed tensors.  Its
cache is keyed, as JAX's (:238-252), by the program's version, the feed
names, shapes and dtypes and the fetch vids.  At a signature's first run
the program is replayed on ``meta`` tensors of the fed shapes first (the
counterpart of the JAX trace at a new signature): a program that cannot
run there, such as one whose model code read a placeholder batch of 1
and baked it in, raises TypeError before any work.  On a CUDA place the
first run at a signature is eager (`core.graphs.capture`'s warm-up, which
returns its fetches), and is then captured into one CUDA graph that
every later run at the signature replays; a failed capture raises.  On
the CPU the replay runs eagerly.  The place is the CUDA device unless
the caller names another (``Executor("cpu")``, ``static.cpu_places()``).

Numpy out (``return_numpy=True``): a bfloat16 fetch comes out as its raw
uint16 words (ROADMAP C2.32), as the port's files carry it (C2.17,
`framework.io_utils.to_numpy`).
Programs with backward or update records (the static training slice)
are not recorded by the port yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree

from ..core import graphs as GR
from ..core.device import resolve_device
from ..framework.io_utils import from_numpy, to_numpy
from . import recorder
from .framework import (Variable, default_main_program,
                        default_startup_program)
from .recorder import _meta_like

__all__ = ["Executor", "global_scope", "scope_guard"]


def to_tensor(value, dtype, device) -> torch.Tensor:
    """A fed value (numpy, tensor, nested list) as a contiguous `dtype`
    tensor on `device`.  A bfloat16 feed given as uint16 words is
    reinterpreted, not converted."""
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value)
        value = from_numpy(arr, dtype == torch.bfloat16
                           and arr.dtype == np.uint16)
    return value.detach().to(device=device, dtype=dtype).contiguous()


def _replay(op, env, cap_vals, device):
    leaves = []
    for kind, v in op.leafspec:
        if kind == "var":
            leaves.append(env[v])
        elif kind == "cap":
            leaves.append(cap_vals[v])
        elif kind == "dev":
            leaves.append(device)
        else:
            leaves.append(v)
    a, kw = _pytree.tree_unflatten(leaves, op.treedef)
    out = op.fn(*a, **kw)
    for kind, val in zip(op.out_kinds, _pytree.tree_leaves(out)):
        if not isinstance(kind, tuple):
            env[kind] = val


def _backward_reach(ops, seed_vids):
    """THE reverse reachability walk (Executor pruning, feed checking and
    save_inference_model pruning).  Returns (kept ops in order, needed
    vids).  An op is kept iff it produces a needed vid."""
    needed = set(seed_vids)
    kept = []
    for op in reversed(ops):
        if not (set(op.out_vids) & needed):
            continue
        kept.append(op)
        needed.update(v for k, v in op.leafspec if k == "var")
    return list(reversed(kept)), needed


def _build(program, feed_names, fetch_vids):
    """The pure whole-program function: (feed tensors, capture tensors,
    device) -> fetch tensors."""
    ops, _ = _backward_reach(program.ops, fetch_vids)
    feed_vids = [program.feed_vars[n].vid for n in feed_names]

    def fn(feed_vals, cap_vals, device):
        env = dict(zip(feed_vids, feed_vals))
        for op in ops:
            _replay(op, env, cap_vals, device)
        return [env[v] for v in fetch_vids]

    return fn


def _place_device(place) -> torch.device:
    """An Executor's place: a device, a device name or index, or None (the
    CUDA device)."""
    if isinstance(place, (list, tuple)):
        place = place[0] if place else None
    if isinstance(place, int):
        place = f"cuda:{place}"
    return resolve_device(place)


class Executor:
    """Run driver for static Programs on one device."""

    def __init__(self, place=None):
        self.place = place
        self.device = _place_device(place)
        # id(program) -> (program, version, {signature: entry}, captures
        # on this device); holding the program keeps its id valid
        self._cache = {}
        self._pool = None   # the memory pool this executor's graphs share

    def _slot(self, program):
        slot = self._cache.get(id(program))
        if slot is None or slot[1] != program._version:
            caps = [c if c.device == self.device
                    else c.detach().to(self.device)
                    for c in program.captures]
            slot = (program, program._version, {}, caps)
            self._cache[id(program)] = slot
        return slot

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, scope=None, **kwargs):
        from .io import _ExportedInferenceProgram

        if isinstance(program, _ExportedInferenceProgram):
            return program._run(feed or {}, return_numpy=return_numpy)
        if program is None:
            program = default_main_program()
        if program is default_startup_program() or not program.ops:
            return []
        feed = feed or {}
        fetch_vids = [self._fetch_vid(program, f) for f in fetch_list or []]
        missing = set(program.feed_vars) - set(feed)
        if missing:
            # an error only where a fetch depends on it
            really = missing & _feeds_needed(program, fetch_vids)
            if really:
                raise KeyError(f"feed missing for data vars: {sorted(really)}")
        feed_names = sorted(n for n in feed if n in program.feed_vars)
        feed_vals = [self._feed_tensor(program.feed_vars[n], feed[n])
                     for n in feed_names]
        _, _, sigs, caps = self._slot(program)
        sig = (tuple(feed_names),
               tuple((tuple(v.shape), str(v.dtype)) for v in feed_vals),
               tuple(fetch_vids))
        with recorder.paused(), torch.no_grad():
            fetches = self._run_at(program, sigs, sig, feed_names,
                                   feed_vals, fetch_vids, caps)
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    @staticmethod
    def _fetch_vid(program, f):
        if isinstance(f, Variable):
            return f.vid
        if isinstance(f, str):
            match = [v for v in program.vars.values() if v.name == f]
            if not match:
                raise KeyError(f"fetch target {f!r} not found")
            return match[0].vid
        raise TypeError(f"bad fetch target: {f!r}")

    def _feed_tensor(self, var, value):
        """The feed as a tensor of the variable's dtype on this device, at
        whatever shape it has: as the JAX Executor retraces a new
        signature, a new shape runs through `_check_on_meta`, which
        raises TypeError for a program that bakes the old one in
        (ROADMAP C2.31)."""
        return to_tensor(value, var.dtype, self.device)

    def _run_at(self, program, sigs, sig, feed_names, feed_vals, fetch_vids,
                caps):
        entry = sigs.get(sig)
        if entry is None:
            fn = _build(program, feed_names, fetch_vids)
            _check_on_meta(fn, feed_vals, caps)
            if self.device.type != "cuda":
                sigs[sig] = (fn, None, None)
            else:
                # the first run is the capture's eager warm-up
                static = [v.clone() for v in feed_vals]
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                out, graph = GR.capture(
                    lambda: fn(static, caps, self.device),
                    GR.capture_stream(self.device), "static::program",
                    pool=self._pool)
                sigs[sig] = (fn, static, graph)
                return out
        fn, static, graph = sigs[sig]
        if graph is None:
            return fn(feed_vals, caps, self.device)
        for dst, src in zip(static, feed_vals):
            dst.copy_(src)
        graph.replay()
        return [o.clone() for o in graph.outputs]

    def close(self):
        self._cache.clear()


def _check_on_meta(fn, feed_vals, caps):
    """Replay `fn` on ``meta`` tensors of the feeds' shapes: a program that
    cannot run at them raises TypeError here, before any work, as the JAX
    trace of a new signature does."""
    try:
        fn([_meta_like(v) for v in feed_vals], [_meta_like(c) for c in caps],
           torch.device("meta"))
    except (RuntimeError, ValueError, IndexError, TypeError) as e:
        shapes = [list(v.shape) for v in feed_vals]
        raise TypeError(f"the program does not run at feed shapes {shapes}:"
                        f" {e}") from e


def _feeds_needed(program, fetch_vids):
    """Which feed names can influence the fetches."""
    _, needed_vids = _backward_reach(program.ops, fetch_vids)
    return {n for n, v in program.feed_vars.items() if v.vid in needed_vids}


def scope_guard(scope):
    import contextlib

    @contextlib.contextmanager
    def g():
        yield scope

    return g()


def global_scope():
    return default_main_program().scope
