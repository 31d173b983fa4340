"""Static-graph program representation (``paddle_tpu/static/framework.py``
counterpart: `Variable` :28, `OpRecord` :72, `Program` :94, the default
programs :154-186, `data` :189, `InputSpec` :207).

A Program is a recorded list of torch calls over symbolic `Variable`s.
A `Variable` is a tensor on the ``meta`` device (shapes and dtypes, no
data): shape inference is running each recorded call on ``meta``
tensors, the counterpart of `jax.eval_shape`.  Captures are the real
tensors a recorded call reads (parameters, buffers, constants folded at
record time), indexed by identity, so a parameter updated in place is
read anew by every run.  The recording itself is `static.recorder`'s.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.dtypes import torch_dtype  # noqa: F401

__all__ = ["InputSpec", "OpRecord", "Program", "Variable", "data",
           "default_main_program", "default_startup_program",
           "program_guard", "reset_default_programs"]


class Variable(torch.Tensor):
    """Symbolic tensor of a Program: a ``meta`` tensor with its Program's
    id (`vid`), a `name` and its `program`.  Any attempt to read data
    fails; `shape` shows a feed's declared ``-1`` dims (the tensor itself
    binds a placeholder 1 there, so that shape inference runs: model
    code that reads the size of such a dim from a recorded value bakes
    the 1 into the program, as in the JAX package)."""

    # the recorder's TorchFunctionMode sees every call first; the class
    # itself takes no part in dispatch
    __torch_function__ = torch._C._disabled_torch_function_impl
    # the kernel wrappers' device check lets a Variable through to the
    # op, whose call is recorded (`ops/kernels/_op.py`)
    _symbolic = True

    @staticmethod
    def __new__(cls, meta, name=None, program=None):
        with torch._C.DisableTorchFunction():
            return torch.Tensor._make_subclass(cls, meta, False)

    def __init__(self, meta, name=None, program=None):
        # the plain meta tensor that shape inference computes with (the
        # meta kernels read `.shape`, which a feed answers with its -1s)
        self._meta = meta
        self.name = name
        self.program = program
        self.is_data = False
        self.declared_shape = None
        self.stop_gradient = True
        self.persistable = False
        self.vid = program._next_vid() if program is not None else -1

    @property
    def name(self):
        return self.__dict__.get("_vname")

    @name.setter
    def name(self, value):
        self.__dict__["_vname"] = value

    @property
    def shape(self):
        if self.declared_shape is not None:
            return list(self.declared_shape)
        with torch._C.DisableTorchFunction():
            return torch.Tensor.shape.__get__(self)

    def numpy(self, *a, **kw):
        raise RuntimeError(
            f"Variable {self.name!r} is symbolic (static mode); run it "
            "through Executor.run(fetch_list=[...]) to get a value")

    def __repr__(self, *a, **kw):
        with torch._C.DisableTorchFunction():
            dtype = str(torch.Tensor.dtype.__get__(self)).replace(
                "torch.", "")
        return f"Variable(name={self.name}, shape={list(self.shape)}, " \
               f"dtype={dtype})"


class OpRecord:
    """One recorded call: `fn` (the torch function, Tensor method, op
    overload or functional), its flattened arguments (`leafspec`: each
    leaf ``("var", vid)``, ``("cap", index)``, ``("dev", None)`` for the
    ``meta`` device a Variable named, replaced by the run's device, or
    ``("py", value)``) with their structure (`treedef`), and its outputs:
    per leaf of the structure `out_tree` a vid (a tensor) or ``("py",
    value)`` (`out_kinds`), the vids alone in `out_vids`.  Backward and
    update records belong to the static training slice."""

    __slots__ = ("name", "fn", "leafspec", "treedef", "out_vids",
                 "out_tree", "out_kinds")

    def __init__(self, name, fn, leafspec, treedef, out_tree, out_kinds):
        self.name = name
        self.fn = fn
        self.leafspec = list(leafspec)
        self.treedef = treedef
        self.out_tree = out_tree
        self.out_kinds = list(out_kinds)
        self.out_vids = [k for k in self.out_kinds
                         if not isinstance(k, tuple)]


class Program:
    """Recorded op list + captured eager tensors + scope state."""

    def __init__(self):
        self.ops = []
        self.captures = []          # real tensors (params, consts)
        self._capture_ids = {}      # id(tensor) -> capture index
        self.scope = {}             # str -> tensor (static.save's scope)
        self.feed_vars = {}         # name -> Variable
        self.vars = {}              # vid -> Variable
        self._vid = 0
        self._version = 0
        self.random_seed = None

    def _next_vid(self):
        self._vid += 1
        return self._vid

    def _bump(self):
        self._version += 1

    def capture(self, tensor):
        idx = self._capture_ids.get(id(tensor))
        if idx is None:
            idx = len(self.captures)
            self.captures.append(tensor)
            self._capture_ids[id(tensor)] = idx
        return idx

    def register_var(self, var):
        self.vars[var.vid] = var
        return var

    def all_parameters(self):
        return [t for t in self.captures
                if isinstance(t, torch.nn.Parameter)]

    def list_vars(self):
        return list(self.vars.values())

    def block(self, i=0):
        return self

    def global_block(self):
        return self

    def clone(self, for_test=False):
        # the recorded list holds no training op: a test clone is itself
        return self

    def __repr__(self):
        return (f"Program(ops={len(self.ops)}, captures={len(self.captures)},"
                f" feeds={list(self.feed_vars)})")


class _Defaults(threading.local):
    def __init__(self):
        self.main = Program()
        self.startup = Program()


_defaults = _Defaults()


def default_main_program():
    return _defaults.main


def default_startup_program():
    return _defaults.startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main, old_startup = _defaults.main, _defaults.startup
    _defaults.main = main_program
    if startup_program is not None:
        _defaults.startup = startup_program
    try:
        yield
    finally:
        _defaults.main = old_main
        _defaults.startup = old_startup


def reset_default_programs():
    _defaults.main = Program()
    _defaults.startup = Program()


def new_variable(meta, name, program):
    """A Variable of `program` over the ``meta`` tensor `meta`,
    registered under a new vid."""
    var = Variable(meta, name=name, program=program)
    program.register_var(var)
    return var


def data(name, shape, dtype=None, lod_level=0):
    """Declare a feed Variable (parity: paddle.static.data).  A ``-1`` (or
    None) dim binds a placeholder 1; `shape` keeps the ``-1``."""
    prog = default_main_program()
    shape = [(-1 if s is None else int(s)) for s in shape]
    with torch._C.DisableTorchFunction():
        meta = torch.empty([1 if s == -1 else s for s in shape],
                           dtype=torch_dtype(dtype), device="meta")
    var = new_variable(meta, name, prog)
    var.is_data = True
    var.declared_shape = shape
    prog.feed_vars[name] = var
    prog._bump()
    return var


class InputSpec:
    """Shape/dtype spec for static feeds (parity:
    `paddle.static.InputSpec`)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(1 if (s is None or s == -1) else int(s)
                           for s in shape)
        self.declared_shape = [(-1 if s is None else int(s)) for s in shape]
        self.dtype = torch_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype,
                   name or getattr(tensor, "name", None))

    def __repr__(self):
        return (f"InputSpec(shape={self.declared_shape}, dtype="
                f"{str(self.dtype).replace('torch.', '')}, name={self.name})")
