"""Static-mode op recording: the append_op analog
(``paddle_tpu/static/recorder.py`` counterpart, :23-93, which the JAX
package's op gate calls, `core/dispatch.py:73-77`).

The port has no op gate of its own.  While static mode is on
(`enable_static()`), a `torch.overrides.TorchFunctionMode` sits on the
thread's mode stack and sees every torch call: a call whose arguments
hold a `Variable` (or name the ``meta`` device a Variable reports, as a
factory call ``torch.arange(n, device=x.device)`` does) becomes one
`OpRecord` of the default main program, its outputs new Variables whose
shapes come from running the call on ``meta`` tensors (the counterpart
of `jax.eval_shape`).  Any other call runs at once, as in JAX (the
inline startup-program semantics: parameter initialisers, constants a
layer folds from its buffers).

The kernels are recorded at their op boundary: a wrapper's device check
lets a Variable through (`ops/kernels/_op.py`), and its call of
``paddle_tpu_torch::<kernel>`` is the record, so recording launches and
counts nothing, and at replay the fed tensors' device picks the op's
CPU plain version or its CUDA kernel.
"""
from __future__ import annotations

import threading

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree

from ..core import flags
from .framework import OpRecord, Variable, default_main_program, new_variable

__all__ = ["disable_static", "enable_static", "in_dynamic_mode",
           "paused", "record"]

def _symbolic(leaf) -> bool:
    return isinstance(leaf, Variable) or (
        isinstance(leaf, torch.device) and leaf.type == "meta")


def _meta_like(t):
    with torch._C.DisableTorchFunction():
        return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                                   dtype=t.dtype, device="meta")


def _op_name(fn) -> str:
    name = getattr(fn, "__name__", None) or str(fn)
    if name == "__get__":
        name = getattr(getattr(fn, "__self__", None), "__name__", name)
    return name.split(".")[0] if name.startswith(
        "paddle_tpu_torch") else name


def record(fn, args, kwargs):
    """Append one call of `fn` to the default main program; return its
    result with every output tensor a new Variable (or, for a call with
    no tensor output, such as a shape read, the plain result)."""
    prog = default_main_program()
    leaves, treedef = _pytree.tree_flatten((args, kwargs))
    name = _op_name(fn)
    if fn is torch.Tensor.__setitem__:
        raise NotImplementedError(
            "static mode: index assignment into a recorded tensor is not "
            "recorded; build the value with torch.where or torch.cat")
    meta = []
    for leaf in leaves:
        if isinstance(leaf, Variable):
            meta.append(leaf._meta)
        elif isinstance(leaf, torch.Tensor):
            if leaf.device.type == "meta":
                raise ValueError(
                    f"op {name!r}: a meta tensor that no Program recorded "
                    "(made outside static mode?)")
            meta.append(_meta_like(leaf))
        else:
            meta.append(leaf)
    a, kw = _pytree.tree_unflatten(meta, treedef)
    with torch.no_grad():
        out = fn(*a, **kw)
    out_leaves, out_tree = _pytree.tree_flatten(out)
    if not any(isinstance(o, torch.Tensor) for o in out_leaves):
        return out      # a read of shape, dtype, device...: nothing to record
    leafspec = []
    for leaf in leaves:
        if isinstance(leaf, Variable):
            if leaf.program is not prog:
                raise ValueError(
                    f"op {name!r} mixes Variables from different Programs")
            leafspec.append(("var", leaf.vid))
        elif isinstance(leaf, torch.Tensor):
            leafspec.append(("cap", prog.capture(leaf)))
        elif _symbolic(leaf):
            leafspec.append(("dev", None))
        else:
            leafspec.append(("py", leaf))
    inputs = {id(leaf._meta): leaf for leaf in leaves
              if isinstance(leaf, Variable)}
    made, kinds = [], []
    for i, o in enumerate(out_leaves):
        if not isinstance(o, torch.Tensor):
            kinds.append(("py", o))
            made.append(o)
            continue
        var = inputs.get(id(o))
        if var is None:
            # an in-place call or one returning its input keeps the
            # input's vid: later reads of the Python object see it
            var = new_variable(o, f"{name}_{prog._vid + 1}.out{i}", prog)
        kinds.append(var.vid)
        made.append(var)
    prog.ops.append(OpRecord(name, fn, leafspec, treedef, out_tree, kinds))
    prog._bump()
    return _pytree.tree_unflatten(made, out_tree)


class _Pause(threading.local):
    def __init__(self):
        self.depth = 0


_pause = _Pause()


class paused:
    """Within: every call runs, none is recorded (an Executor's replay,
    `torch.export` of a recorded program, which traces with modes of its
    own): the recorder leaves this thread's mode stack while it is on
    top of it, and lets calls through while another mode is above it."""

    def __enter__(self):
        _pause.depth += 1
        rec = _mode.recorder
        stack = torch.overrides._get_current_function_mode_stack()
        self.popped = rec is not None and bool(stack) and stack[-1] is rec
        if self.popped:
            torch.overrides._pop_mode()

    def __exit__(self, *exc):
        if self.popped:
            torch.overrides._push_mode(_mode.recorder)
        _pause.depth -= 1
        return False


class _Recorder(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _pause.depth or not any(
                _symbolic(leaf)
                for leaf in _pytree.tree_leaves((args, kwargs))):
            return func(*args, **kwargs)
        return record(func, args, kwargs)


class _Mode(threading.local):
    def __init__(self):
        self.recorder = None


_mode = _Mode()


def enable_static():
    """Switch this thread to static-graph (program-building) mode
    (paddle.enable_static): the recorder joins the thread's torch
    function mode stack."""
    if _mode.recorder is None:
        rec = _Recorder()
        rec.__enter__()
        _mode.recorder = rec
    flags.set_static_mode(True)


def disable_static(place=None):
    rec = _mode.recorder
    if rec is not None:
        stack = torch.overrides._get_current_function_mode_stack()
        if not stack or stack[-1] is not rec:
            raise RuntimeError(
                "disable_static: another torch function mode entered "
                "after enable_static() is still active; exit it first")
        rec.__exit__(None, None, None)
        _mode.recorder = None
    flags.set_static_mode(False)


def in_dynamic_mode():
    return not flags.in_static_mode()
