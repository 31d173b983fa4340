"""Inference-model files of static programs (``paddle_tpu/static/io.py``
counterpart: `save_inference_model` :25, `_ExportedInferenceProgram`
:114, `load_inference_model` :138).

`save_inference_model` prunes the program to what the fetches need and
exports the pure function ``(captures, feeds) -> fetches`` with
`torch.export`, one `torch.export.Dim` for each declared ``-1`` dim (the
JAX package's symbolic shapes).  A program that cannot take such a dim
(its model code baked the placeholder 1 in) is exported with those dims
set to 1, after a RuntimeWarning naming the narrowed signature, as JAX
does (:80-99).  ``.pdmodel`` is the `torch.export.save` archive (as
`jit.save` writes it, ROADMAP C2.29); ``.pdiparams`` a pickle with the
JAX package's keys, the captures as numpy (bfloat16 as its uint16
words, C2.17).  The kernels are ``paddle_tpu_torch::<kernel>`` nodes of
the program.

`load_inference_model` moves the program to its device
(`move_to_device_pass`, as `jit.load` does) and returns it with the
feed and fetch names; `Executor.run(program, feed=...)` and the
`inference.Predictor` run it.  On a CUDA device each input signature's
first run is eager and is then captured into one CUDA graph that later
runs replay (`core.graphs`); a failed capture raises.
"""
from __future__ import annotations

import copy
import os
import pickle
import warnings

import numpy as np
import torch

from ..core import graphs as GR
from ..core.device import resolve_device
from . import recorder
from ..framework.io_utils import to_numpy
from .executor import _backward_reach, _build, to_tensor
from .framework import default_main_program

__all__ = ["load_inference_model", "save_inference_model"]


class _PureProgram(torch.nn.Module):
    """The pruned program as a module of (captures, feeds); the function
    is held outside the module tree, so the export lifts no state."""

    def __init__(self, fn, device):
        super().__init__()
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_device", device)

    def forward(self, caps, feeds):
        return self._fn(list(feeds), list(caps), self._device)


def _declared(v):
    return list(getattr(v, "declared_shape", None) or v.shape)


def _export(mod, caps, feed_vars, device, symbolic):
    """`torch.export` of `mod` at example feeds (zeros; 2 on each declared
    -1 dim when `symbolic`, else 1), the -1 dims dynamic when
    `symbolic`."""
    feeds, dyn = [], []
    for i, v in enumerate(feed_vars):
        decl = _declared(v)
        fill = 2 if symbolic else 1
        feeds.append(torch.zeros([fill if d == -1 else d for d in decl],
                                 dtype=v.dtype, device=device))
        dims = {j: torch.export.Dim(f"d{i}_{j}")
                for j, d in enumerate(decl) if d == -1 and symbolic}
        dyn.append(dims or None)
    with recorder.paused(), torch.no_grad():
        return torch.export.export(
            mod, (list(caps), feeds),
            dynamic_shapes=([None] * len(caps), dyn), strict=False)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Write ``path_prefix.pdmodel`` and ``.pdiparams`` for the program's
    forward from `feed_vars` to `fetch_vars`."""
    program = program or default_main_program()
    if not isinstance(feed_vars, (list, tuple)):
        feed_vars = [feed_vars]
    if not isinstance(fetch_vars, (list, tuple)):
        fetch_vars = [fetch_vars]
    feed_names = [v.name for v in feed_vars]
    fetch_vids = [v.vid for v in fetch_vars]

    # prune to the forward subgraph reaching the fetches
    keep, needed = _backward_reach(program.ops, fetch_vids)
    pruned = copy.copy(program)
    pruned.ops = keep
    unresolved = needed - {v.vid for v in feed_vars} \
        - {vid for op in pruned.ops for vid in op.out_vids}
    if unresolved:
        raise ValueError(
            "fetch_vars depend on values that neither a feed nor an op "
            f"gives; unresolved vids: {sorted(unresolved)}")
    fn = _build(pruned, feed_names, fetch_vids)
    caps = [c.detach() for c in program.captures]
    device = caps[0].device if caps else torch.device("cpu")
    mod = _PureProgram(fn, device)
    symbolic = any(d == -1 for v in feed_vars for d in _declared(v))
    try:
        exported = _export(mod, caps, feed_vars, device, symbolic)
    except Exception as e:
        if not symbolic:
            raise
        # the program is not shape-polymorphic: fix the -1 dims to 1,
        # loudly, since the saved signature narrows
        narrowed = [[1 if d == -1 else d for d in _declared(v)]
                    for v in feed_vars]
        warnings.warn(
            f"shape-polymorphic export failed ({type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else ''}); saving with the "
            f"-1 dims fixed to 1 — the frozen model will only accept feed "
            f"shapes {narrowed}", RuntimeWarning)
        exported = _export(mod, caps, feed_vars, device, False)

    # the archive would keep the example inputs, the captures among them:
    # they travel in .pdiparams
    exported.example_inputs = None
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        torch.export.save(exported, f)
    with open(path_prefix + ".pdiparams", "wb") as f:
        pickle.dump({
            "format": "static_inference",
            "caps": [to_numpy(c) for c in caps],
            "feed_names": feed_names,
            "fetch_names": [v.name for v in fetch_vars],
        }, f)
    return path_prefix


def _user_inputs(exported):
    """The example values (fake tensors, symbolic dims included) of the
    exported program's user inputs, in order."""
    names = set(exported.graph_signature.user_inputs)
    return [n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder" and n.name in names]


class _ExportedInferenceProgram:
    """Loaded frozen program on `device`: `Executor.run(self, feed=...)`
    and the `Predictor` run it."""

    def __init__(self, exported, caps, feed_names, fetch_names, device):
        self.exported = exported
        self.module = exported.module()
        self.device = device
        vals = _user_inputs(exported)
        self.caps = [to_tensor(c, v.dtype, device)
                     for c, v in zip(caps, vals)]
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        # per feed: its shape (-1 on a dynamic dim) and dtype
        self.feed_specs = [
            ([d if isinstance(d, int) else -1 for d in v.shape], v.dtype)
            for v in vals[len(caps):]]
        self._graphs = {}   # feed signature -> (static feeds, graph)
        self._pool = None

    def feed_tensors(self, feed):
        """The feeds, in the program's order, as tensors on its device;
        a missing feed raises KeyError, a shape the program does not take
        ValueError."""
        vals = []
        for n, (shape, dtype) in zip(self.feed_names, self.feed_specs):
            if n not in feed:
                raise KeyError(f"missing feed {n!r}")
            t = to_tensor(feed[n], dtype, self.device)
            if t.dim() != len(shape) or any(
                    d != -1 and d != s for d, s in zip(shape, t.shape)):
                raise ValueError(f"feed {n!r} has shape {list(t.shape)}; "
                                 f"the saved program takes {shape}")
            vals.append(t)
        return vals

    def call(self, vals):
        """One eager call of the loaded program on feed tensors."""
        with recorder.paused(), torch.no_grad():
            return list(self.module(self.caps, vals))

    def run_tensors(self, vals):
        """The program at `vals` (feed tensors on its device): eager on the
        CPU; on CUDA the signature's CUDA graph, captured at its first
        run, whose eager warm-up gives that run's outputs."""
        if self.device.type != "cuda":
            return self.call(vals)
        sig = tuple((tuple(v.shape), v.dtype) for v in vals)
        entry = self._graphs.get(sig)
        with recorder.paused(), torch.no_grad():
            if entry is None:
                static = [v.clone() for v in vals]
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                out, graph = GR.capture(
                    lambda: list(self.module(self.caps, static)),
                    GR.capture_stream(self.device), "static::inference",
                    pool=self._pool)
                self._graphs[sig] = (static, graph)
                return out
            static, graph = entry
            for dst, src in zip(static, vals):
                dst.copy_(src)
            graph.replay()
            return [o.clone() for o in graph.outputs]

    def _run(self, feed, return_numpy=True):
        out = self.run_tensors(self.feed_tensors(feed))
        if return_numpy:
            return [to_numpy(o) for o in out]
        return out


def load_inference_model(path_prefix, executor=None, device=None, **kwargs):
    """[program, feed_names, fetch_names] of the files `path_prefix`
    names, the program on `device` (else the executor's, else the CUDA
    device)."""
    from torch.export.passes import move_to_device_pass

    if device is None and executor is not None:
        device = executor.device
    dev = resolve_device(device)
    with open(path_prefix + ".pdiparams", "rb") as f:
        meta = pickle.load(f)
    with recorder.paused():
        with open(path_prefix + ".pdmodel", "rb") as f:
            exported = move_to_device_pass(torch.export.load(f), dev)
    prog = _ExportedInferenceProgram(
        exported, [np.asarray(c) for c in meta["caps"]], meta["feed_names"],
        meta["fetch_names"], dev)
    return [prog, prog.feed_names, prog.fetch_names]
