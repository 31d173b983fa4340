"""`to_static`: a function or a layer's forward as one fixed-shape
program per input signature (``paddle_tpu/jit/api.py`` counterpart:
`to_static` :223, `StaticFunction` :64, `_sig_of` :52).

The JAX package traces the function once per signature of its arguments
(the shapes and dtypes of its tensors, the `repr` of everything else)
into one XLA program and replays that.  Here, on a CUDA device, in eval
mode and with grad off, each signature's first call copies its tensor
arguments into static tensors, runs the function eagerly once on them
on the capture stream (`core.graphs.warm_up`), captures it into one
CUDA graph in the `StaticFunction`'s memory pool and replays it; every
later call copies its tensors into the static ones and replays.  The
outputs come back as clones, as the JAX program returns fresh arrays:
the next replay of any graph of the pool rewrites the graph's own.  A
layer's parameters or buffers rebound since a capture (a
`load_state_dict` copies in place; `.to()` rebinds) drop every graph,
and the next call captures again.  A replay calls no forward hook of
the layer or of its modules.  On the CPU the function runs eagerly.

Not ported: training through a compiled program (the JAX program is one
op on the tape, so `backward()` works through it: ROADMAP Queue A6) and
the `backend="sot"` capture tier, `save` and `load` (Queue A9).  Training
mode, grad enabled and `backend="sot"` raise NotImplementedError; none
runs the function eagerly instead.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import _pytree

from ..core import graphs as GR

__all__ = ["StaticFunction", "to_static"]


def _sig_of(x):
    """The signature of one argument, with the JAX package's classes: a
    tensor's shape and dtype, a sequence's or a dict's items, the `repr`
    of anything else."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, (list, tuple)):
        return tuple(_sig_of(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _sig_of(v)) for k, v in x.items()))
    return ("S", repr(x))


class _Program:
    """One signature's graph: the static tensors it reads (the call's
    tensor leaves, in order) and what it holds of the layer's state."""

    def __init__(self, inputs, graph, bound):
        self.inputs, self.graph, self.bound = inputs, graph, bound


class StaticFunction:
    """`function` (a function, a bound method of a layer, or a layer,
    whose forward it wraps) replayed per input signature."""

    def __init__(self, function, input_spec=None, build_strategy=None,
                 backend=None, **kwargs):
        self._fn = function
        self._layer = None
        if isinstance(function, nn.Module):
            self._layer = function
            self._fn = function.forward
        elif isinstance(getattr(function, "__self__", None), nn.Module):
            self._layer = function.__self__
        self._input_spec = input_spec
        self._cache = {}          # call signature -> _Program
        self._pool = None         # the memory pool its graphs share
        # the JAX package's compile label (`jit::<fn>`): its captures
        # are timed under it
        self._label = f"jit::{getattr(self._fn, '__name__', 'fn')}"
        functools.update_wrapper(self, self._fn)

    @property
    def layer(self):
        return self._layer

    def _state(self) -> list:
        if self._layer is None:
            return []
        return list(self._layer.parameters()) + list(self._layer.buffers())

    def _refuse(self) -> None:
        """Training and grad enabled are not ported; neither runs eagerly
        instead."""
        if self._layer is not None and self._layer.training:
            raise NotImplementedError(
                "to_static in training mode is not ported yet (ROADMAP "
                "Queue A6: training through a compiled program); call "
                ".eval() to serve")
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "to_static with grad enabled is not ported yet (ROADMAP "
                "Queue A6: backward through a compiled program); call it "
                "under torch.no_grad() or torch.inference_mode()")

    def __call__(self, *args, **kwargs):
        self._refuse()
        leaves, _ = _pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        device = tensors[0].device if tensors else next(
            iter(self._state()), torch.empty(())).device
        if device.type == "cpu":
            return self._fn(*args, **kwargs)
        return self._replay(args, kwargs, device)

    def _replay(self, args, kwargs, device):
        """The CUDA path of `__call__`: the signature's graph, captured at
        its first call, replayed over the call's tensors; the outputs
        cloned."""
        leaves, spec = _pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        key = (str(device), _sig_of(args), _sig_of(kwargs))
        bound = GR.addresses(self._state())
        if any(p.bound != bound for p in self._cache.values()):
            self._cache.clear()
        prog = self._cache.get(key)
        if prog is None:
            with torch.inference_mode(False):
                inputs = [torch.empty_like(t) for t in tensors]
            it = iter(inputs)
            static = [next(it) if isinstance(x, torch.Tensor) else x
                      for x in leaves]
            args, kwargs = _pytree.tree_unflatten(static, spec)
            for dst, src in zip(inputs, tensors):
                dst.copy_(src)
            body = functools.partial(self._fn, *args, **kwargs)
            stream = GR.capture_stream(device)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            _, graph = GR.capture(body, stream, self._label, pool=self._pool)
            prog = _Program(inputs, graph, bound)
            self._cache[key] = prog
        else:
            for dst, src in zip(prog.inputs, tensors):
                dst.copy_(src)
        prog.graph.replay()
        return _pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            prog.graph.outputs)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """A `StaticFunction` of `function`; a layer gets one as its forward
    and is returned.  Usable as a decorator, with or without arguments.
    `backend="sot"` (the JAX package's eager-capture tier) raises."""
    if backend in ("sot", "SOT"):
        raise NotImplementedError(
            "to_static(backend='sot') is not ported yet (ROADMAP Queue A9: "
            "the rest of jit/)")

    def decorate(fn):
        if isinstance(fn, nn.Module):
            fn.forward = StaticFunction(fn.forward, input_spec)
            return fn
        return StaticFunction(fn, input_spec)

    if function is not None:
        return decorate(function)
    return decorate
