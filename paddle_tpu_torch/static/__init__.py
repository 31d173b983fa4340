"""paddle_tpu_torch.static: the static-graph (program-building) API,
forward programs (``paddle_tpu/static/__init__.py`` counterpart).

The JAX package's path Program -> `jax.eval_shape` -> `jax.jit` ->
`jax.export` becomes, in the port: record torch calls on symbolic
`Variable`s (`framework.py`, `recorder.py`), infer their shapes on the
``meta`` device, replay them as one CUDA graph per feed signature
(`executor.py`), serialize with `torch.export` (`io.py`).

Design rule (as in JAX): only calls with a symbolic Variable among their
arguments record into the Program; calls over eager tensors alone
(parameter initialisers, constants a layer folds) run at once.

Not exported yet (the static training slice, ROADMAP): `append_backward`,
`gradients`, `minimize_static`, the Executor's backward and update
records, `static.nn`'s control flow and its other builders,
`ExponentialMovingAverage`, `py_func` and `Print`.
"""
from __future__ import annotations

import contextlib
import pickle

import numpy as np
import torch

from . import nn  # noqa: F401
from .executor import Executor, global_scope, scope_guard  # noqa: F401
from .framework import (  # noqa: F401
    InputSpec, Program, Variable, data, default_main_program,
    default_startup_program, program_guard, reset_default_programs,
    torch_dtype,
)
from .io import load_inference_model, save_inference_model  # noqa: F401


def CompiledProgram(program, build_strategy=None):
    """Every Program runs as one CUDA graph a feed signature already;
    identity shim."""
    return program


class BuildStrategy:
    """No-op strategy carrier (the graph replays what was recorded)."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = True


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


@contextlib.contextmanager
def device_guard(device=None):
    yield


def cpu_places(device_count=None):
    return [torch.device("cpu")]


def cuda_places(device_ids=None):
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [torch.device("cuda", int(i)) for i in device_ids]


def xpu_places(device_ids=None):
    return []


# ---- the program-file API (JAX :74-197) ----

def _name(p, i):
    return getattr(p, "name", None) or f"p{i}"


def _np_of(v):
    from ..framework.io_utils import to_numpy

    return to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def _set(p, value):
    """Copy `value` (numpy, bfloat16 as uint16 words, or a tensor) into
    the parameter `p` in place."""
    from .executor import to_tensor

    with torch.no_grad():
        p.copy_(to_tensor(value, p.dtype, p.device).reshape(p.shape))


def save(program, model_path, protocol=4, **configs):
    """Persist a Program's parameters + scope (reference static.save)."""
    state = {"params": {_name(p, i): _np_of(p)
                        for i, p in enumerate(program.all_parameters())},
             "scope": {k: _np_of(v) for k, v in program.scope.items()}}
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(state, f, protocol=protocol)
    return model_path + ".pdparams"


def load(program, model_path, executor=None, var_list=None):
    """Reload static.save output into the program (reference static.load):
    parameters in place, the scope as tensors."""
    with open(model_path + ".pdparams", "rb") as f:
        state = pickle.load(f)
    set_program_state(program, state["params"])
    for k, v in state.get("scope", {}).items():
        program.scope[k] = torch.as_tensor(np.asarray(v))
    return program


def serialize_program(feed_vars, fetch_vars, **kwargs):
    """Serialized bytes of the recorded program's structure (reference
    serialize_program's pb bytes role): pickled op-list metadata."""
    prog = default_main_program()
    meta = {"n_ops": len(prog.ops),
            "feeds": [getattr(v, "name", None) for v in feed_vars],
            "fetches": [getattr(v, "name", None) for v in fetch_vars]}
    return pickle.dumps(meta, protocol=4)


def serialize_persistables(feed_vars, fetch_vars, **kwargs):
    prog = default_main_program()
    return pickle.dumps({_name(p, i): _np_of(p)
                         for i, p in enumerate(prog.all_parameters())},
                        protocol=4)


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data):
    return pickle.loads(data)


def deserialize_persistables(program, data, executor=None):
    return set_program_state(program, pickle.loads(data))


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """The recorded program is already minimal (a pure op list):
    identity."""
    return program


def load_program_state(model_path, var_list=None):
    with open(model_path + ".pdparams", "rb") as f:
        return pickle.load(f)["params"]


def set_program_state(program, state_dict):
    """Write `state_dict`'s values into the program's parameters in place;
    the program's version moves on, so an Executor copies its captures
    to its device again (the JAX Executor reads every capture at each
    run)."""
    for i, p in enumerate(program.all_parameters()):
        name = _name(p, i)
        if name in state_dict:
            _set(p, state_dict[name])
    program._version += 1
    return program


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None, device=None):
    """A filled tensor on `device` (the CUDA device unless given; the CPU
    with `force_cpu`)."""
    from ..core.device import resolve_device

    dev = resolve_device("cpu" if force_cpu else device)
    t = torch.full(list(shape), value, dtype=torch_dtype(dtype), device=dev)
    t.persistable = persistable
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None, device=None):
    """A trainable parameter on `device` (the CUDA device unless given):
    zeros for a bias, else Xavier-uniform as `nn.Linear`'s weight, or
    `default_initializer(tensor)` filling it in place."""
    import math

    from ..core.device import resolve_device

    dev = resolve_device(device)
    t = torch.zeros(list(shape), dtype=torch_dtype(dtype), device=dev)
    if default_initializer is not None:
        default_initializer(t)
    elif not is_bias:
        fan = sum(shape[-2:]) if len(shape) >= 2 else shape[0]
        limit = math.sqrt(6.0 / fan)
        t.uniform_(-limit, limit)
    return torch.nn.Parameter(t)
