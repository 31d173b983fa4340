"""`to_static`: a function or a layer's forward as fixed-shape programs
per input signature (``paddle_tpu/jit/api.py`` counterpart: `to_static`
:223, `StaticFunction` :64, `_sig_of` :52).

The JAX package traces the function once per signature of its arguments
(the shapes and dtypes of its tensors, the `repr` of everything else,
and the layer's ``training`` flag, :151-156) into one XLA program and
puts that program on the tape as one op, so `backward()` runs through
it (:150-222).  Here, on a CUDA device, programs are CUDA graphs in the
`StaticFunction`'s memory pool, cached by the signature, the layer's
``training`` flag, whether grad is on and the `amp.auto_cast` state.
On the CPU the function runs eagerly.

With grad off (serving): each signature's first call copies its tensor
arguments into static tensors, runs the function eagerly once on them
on the capture stream (`core.graphs.warm_up`), captures it into one
graph and replays it; every later call copies its tensors into the
static ones and replays.  The outputs come back as clones, as the JAX
program returns fresh arrays: the next replay of any graph of the pool
rewrites the graph's own.

With grad on (training, `_TrainProgram`): a signature's program is two
graphs, the forward and the backward, run through one autograd
function (`_Replayed`), so `loss.backward()` replays the backward graph
and the gradients of the parameters (and of any argument that requires
grad) reach autograd, which accumulates them into ``.grad`` as in eager
mode: gradient accumulation over micro-batches holds.  The first call
of a signature is eager: its forward runs on the capture stream, its
backward is warmed up once there (zero cotangents: every kernel of both
directions is built before a capture), the two graphs are captured, and
this call's own backward runs eagerly through the warm-up's tape.  Every
later call replays.  Dropout draws from the device's generator
(`core.rng`), registered with the forward graph, so each replay draws
new masks and advances it as an eager call would (JAX threads its key,
:109-127); buffers such as batch norm's running statistics are updated
in place by the forward graph (JAX writes them back, :201-207).  A
replay's saved activations belong to its program: the backward of a call
must run before the next forward of the same signature (the standard
forward / backward alternation of micro-batches); otherwise it raises.

A layer's parameters or buffers rebound since a capture (`amp.decorate`
or a ``.to()``; a `load_state_dict` copies in place) drop every graph,
and the next call captures again.  A replay calls no forward hook of the
layer or of its modules.  A capture that fails raises; nothing runs the
function eagerly instead.  The `backend="sot"` capture tier, `save` and
`load` are not ported (Queue A9): `backend="sot"` raises.
"""
from __future__ import annotations

import functools
import os
import pickle

import torch
from torch import nn
from torch.utils import _pytree

from ..amp import gate as _amp
from ..core import graphs as GR
from ..core import rng
from ..core.device import resolve_device
from ..framework.io_utils import load as fload, save as fsave
from ..observability import capture_cost as CC

__all__ = ["StaticFunction", "TranslatedLayer", "load", "save",
           "to_static"]


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


def _amp_key():
    """The `amp.auto_cast` state a capture is taken under."""
    st = _amp.state
    return (st.enabled, str(st.dtype), tuple(sorted(st.custom_white)),
            tuple(sorted(st.custom_black))) if st.enabled else None


def _flat(out) -> list:
    return [x for x in _pytree.tree_flatten(out)[0]
            if isinstance(x, torch.Tensor)]


def _differentiable(outs) -> list:
    return [o for o in outs if o.requires_grad]


class _TrainProgram:
    """One signature's training program: the static tensors the graphs
    read (the call's tensor leaves), the differentiable inputs of the
    backward (the static leaves that require grad, then the layer's
    parameters that do), the forward graph (its outputs: the function's
    output structure, tensors in the pool), the static cotangents of the
    forward's differentiable outputs, the backward graph (its outputs:
    one gradient or None per differentiable input), the output structure
    and each output tensor's attributes as the first call gave them,
    and `calls`, the count of forward replays (a backward checks that
    its call is the newest)."""

    def __init__(self, inputs, diff, bound):
        self.inputs, self.diff, self.bound = inputs, diff, bound
        self.fwd = self.bwd = None
        self.gouts = []
        self.leaves = self.spec = None
        self.attrs = []
        self.calls = 0

    def flat_outputs(self):
        return _flat(self.fwd.outputs)


class _Replayed(torch.autograd.Function):
    """A training call as one op on the tape: the forward replays the
    program's forward graph (or, at the signature's first call, is the
    eager warm-up, `eager` its flat outputs with their tape), the
    backward replays its backward graph (or runs the warm-up's tape).
    Inputs: the program, the eager outputs or None, then the call's
    differentiable tensors (the arguments that require grad, then the
    parameters), to which the gradients go."""

    @staticmethod
    def forward(ctx, prog, eager, *diff):
        ctx.prog, ctx.eager, ctx.call = prog, eager, prog.calls
        outs = eager if eager is not None else prog.flat_outputs()
        ctx.diff_out = [i for i, o in enumerate(outs) if o.requires_grad]
        made = tuple(o.detach() if eager is not None
                     else o.detach().clone() for o in outs)
        ctx.mark_non_differentiable(*[m for m, o in zip(made, outs)
                                      if not o.requires_grad])
        return made

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        prog = ctx.prog
        cot = [grads[i] for i in ctx.diff_out]
        if ctx.eager is not None:
            outs = [ctx.eager[i] for i in ctx.diff_out]
            got = torch.autograd.grad(
                outs, prog.diff, [torch.zeros_like(o) if g is None else g
                                  for o, g in zip(outs, cot)],
                allow_unused=True)
        else:
            if ctx.call != prog.calls:
                raise RuntimeError(
                    "to_static: a later call of this signature replayed "
                    "its forward graph before this call's backward; run "
                    "each call's backward before the next call")
            for dst, g in zip(prog.gouts, cot):
                if g is None:
                    dst.zero_()
                else:
                    dst.copy_(g)
            prog.bwd.replay()
            got = [None if g is None else g.clone()
                   for g in prog.bwd.outputs]
        return (None, None) + tuple(got)


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

    def _training(self) -> bool:
        return self._layer.training if self._layer is not None else True

    def __call__(self, *args, **kwargs):
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
        # with grad on, which arguments require grad is part of the key:
        # they are the backward's inputs
        key = (str(device), _sig_of(args), _sig_of(kwargs), self._training(),
               torch.is_grad_enabled() and tuple(t.requires_grad
                                                 for t in tensors),
               _amp_key())
        bound = GR.addresses(self._state())
        if any(p.bound != bound for p in self._cache.values()):
            self._cache.clear()
        if torch.is_grad_enabled():
            return self._replay_train(key, leaves, spec, tensors, bound,
                                      device)
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


    def _replay_train(self, key, leaves, spec, tensors, bound, device):
        """The CUDA path with grad on: the signature's `_TrainProgram`
        (made and captured at its first call, which runs eagerly) run
        through `_Replayed`; the outputs in the function's structure."""
        prog = self._cache.get(key)
        eager = None
        if prog is None:
            prog, eager = self._capture_train(leaves, spec, tensors, bound,
                                              device)
            self._cache[key] = prog
        else:
            with torch.no_grad():
                for dst, src in zip(prog.inputs, tensors):
                    dst.copy_(src)
            prog.fwd.replay()
            prog.calls += 1
        wanted = [t for t in tensors if t.requires_grad]
        params = prog.diff[len(wanted):]
        made = iter(_Replayed.apply(prog, eager, *wanted, *params))
        attrs = iter(prog.attrs)
        out = []
        for x in prog.leaves:
            if isinstance(x, torch.Tensor):
                x = next(made)
                # markers the function sets on its outputs (the GPT
                # fused head's `fused_head_hidden`) come along
                x.__dict__.update(next(attrs))
            out.append(x)
        return _pytree.tree_unflatten(out, prog.spec)

    def _capture_train(self, leaves, spec, tensors, bound, device):
        """The first call of a training signature: the forward run
        eagerly on the capture stream on static copies of the call's
        tensors (this call's outputs, with their tape), the backward
        warmed up there with zero cotangents, then the forward and the
        backward captured into the pool.  Returns the program and the
        eager call's flat outputs."""
        with torch.no_grad():
            inputs = [torch.empty_like(t) for t in tensors]
            for dst, src in zip(inputs, tensors):
                dst.copy_(src)
        for dst, src in zip(inputs, tensors):
            dst.requires_grad_(src.requires_grad)
        it = iter(inputs)
        static = [next(it) if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        args, kwargs = _pytree.tree_unflatten(static, spec)
        params = [p for p in self._state()
                  if isinstance(p, nn.Parameter) and p.requires_grad]
        prog = _TrainProgram(inputs, [t for t in inputs if t.requires_grad]
                             + params, bound)
        fn = self._fn

        def forward():
            with torch.enable_grad():
                return fn(*args, **kwargs)

        def warm():
            out = forward()
            prog.leaves, prog.spec = _pytree.tree_flatten(out)
            outs = _flat(out)
            diff = _differentiable(outs)
            if diff and prog.diff:
                torch.autograd.grad(diff, prog.diff,
                                    [torch.zeros_like(o) for o in diff],
                                    allow_unused=True, retain_graph=True)
            return outs

        def backward():
            return torch.autograd.grad(
                _differentiable(prog.flat_outputs()), prog.diff, prog.gouts,
                allow_unused=True, retain_graph=True)

        stream = GR.capture_stream(device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with CC.CaptureTiming(self._label) as timing:
            eager = GR.warm_up(warm, stream)
            timing.warmed()
            prog.attrs = [dict(o.__dict__) for o in eager]
            prog.fwd = GR.Graph(forward, stream, pool=self._pool,
                                generators=(rng.generator(device),))
            with torch.no_grad():
                prog.gouts = [torch.empty_like(o)
                              for o in _differentiable(eager)]
            if prog.gouts and prog.diff:
                prog.bwd = GR.Graph(backward, stream, pool=self._pool)
        return prog, eager


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


def _spec_tensor(spec, device):
    """An example input of the spec's fixed shape and dtype: a tensor
    (its own shape and dtype), or anything with ``.shape`` and
    ``.dtype`` (a torch, numpy or dtype-name dtype)."""
    if isinstance(spec, torch.Tensor):
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if not hasattr(spec, "shape"):
        return spec
    dtype = spec.dtype if isinstance(spec.dtype, torch.dtype) else \
        getattr(torch, str(spec.dtype).replace("torch.", ""))
    return torch.zeros(tuple(spec.shape), dtype=dtype, device=device)


class _Pure(nn.Module):
    """The layer's forward as a pure function of (params, buffers,
    *inputs).  The layer is held outside the module tree, so the
    exported program lifts none of its tensors as state."""

    def __init__(self, layer):
        super().__init__()
        object.__setattr__(self, "_layer", layer)

    def forward(self, params, buffers, *inputs):
        return torch.func.functional_call(self._layer, (params, buffers),
                                          inputs, strict=False)


class _ExportMode:
    """The layer as it is exported, and back as it was on exit: eval
    mode (JAX :293-308), and its own forward in place of a `to_static`
    wrapper (JAX :275-280: trace the function, not its graph
    replays)."""

    def __init__(self, layer):
        self.layer = layer
        self.training = layer.training
        static = layer.__dict__.get("forward")
        self.static = static if isinstance(static, StaticFunction) else None

    def __enter__(self):
        if self.static is not None:
            del self.layer.forward
        self.layer.eval()

    def __exit__(self, *exc):
        self.layer.train(self.training)
        if self.static is not None:
            self.layer.forward = self.static
        return False


def save(layer, path, input_spec=None, **configs):
    """Write `layer` (a layer, or a `StaticFunction` of one) for
    deployment: ``path.pdparams``, ``path.pdmeta`` and, with an
    `input_spec`, the exported program ``path.pdmodel``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    target = layer.layer if isinstance(layer, StaticFunction) else layer
    is_layer = isinstance(target, nn.Module)
    state = target.state_dict() if is_layer else {}
    fsave(state, path + ".pdparams")
    exported = False
    if input_spec is not None and is_layer:
        params = {n: p.detach() for n, p in target.named_parameters()}
        buffers = {n: b for n, b in target.named_buffers() if n in state}
        device = next(iter(state.values()), torch.empty(())).device
        inputs = tuple(_spec_tensor(s, device) for s in input_spec)
        with _ExportMode(target), torch.no_grad():
            program = torch.export.export(
                _Pure(target), (params, buffers, *inputs), strict=False)
        # the archive would keep the example inputs, the parameters among
        # them: they travel in .pdparams
        program.example_inputs = None
        with open(path + ".pdmodel", "wb") as f:
            torch.export.save(program, f)
        exported = True
    meta = {"exported": exported, "class": type(target).__name__}
    if is_layer:
        meta["param_names"] = [n for n, _ in target.named_parameters()]
        meta["buffer_names"] = [n for n, _ in target.named_buffers()
                                if n in state]
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f)


class TranslatedLayer(nn.Module):
    """Deployment-side loaded model (parity: paddle.jit.TranslatedLayer /
    C++ jit::Layer): the exported program, called with the saved state
    bound at each call."""

    def __init__(self, exported, state, param_names=(), buffer_names=()):
        super().__init__()
        self._exported = exported
        self._program = exported.module()
        self._state = state
        self._param_names = list(param_names)
        self._buffer_names = list(buffer_names)

    def forward(self, *inputs):
        p = {k: self._state[k] for k in self._param_names
             if k in self._state}
        b = {k: self._state[k] for k in self._buffer_names
             if k in self._state}
        return self._program(p, b, *inputs)


def load(path, device=None, **configs):
    """A `TranslatedLayer` of what `save` wrote at `path`, on `device`
    (default: the CUDA device): the program moved there
    (`move_to_device_pass`) with its state."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    state = fload(path + ".pdparams", device=dev) \
        if os.path.exists(path + ".pdparams") else {}
    meta_path = path + ".pdmeta"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path, "rb") as f:
            meta = pickle.load(f)
    if meta.get("exported") and os.path.exists(path + ".pdmodel"):
        with open(path + ".pdmodel", "rb") as f:
            program = move_to_device_pass(torch.export.load(f), dev)
        return TranslatedLayer(program, state, meta.get("param_names", ()),
                               meta.get("buffer_names", ()))
    raise FileNotFoundError(
        f"no exported program at {path}.pdmodel; load params with "
        f"paddle_tpu_torch.load({path!r} + '.pdparams') instead")
