"""The forward wrappers that a served model's forward reaches, as
`torch.library` custom ops named ``paddle_tpu_torch::<kernel>``.

A wrapper called through `ctypes` cannot be traced: `torch.export`
traces with fake tensors, which have no `data_ptr`.  As a custom op the
kernel is one node of an exported program (`jit.save`), and a loaded
program calls it again.  Each op has three implementations, registered
here and kept in `IMPLS` for the port's rule tests:

  * ``cpu``: the plain PyTorch version, the only place it runs;
  * ``cuda``: the launch, which checks its inputs, launches the kernel
    or raises, and adds one to the kernel's launch counter, so a loaded
    or replayed program counts its launches;
  * ``fake``: the output shapes and dtypes, for tracing.

The ops take no part in autograd: each kernel's `torch.autograd.Function`
calls its wrapper inside its forward, where grad is off.
"""
from __future__ import annotations

import torch

NAMESPACE = "paddle_tpu_torch"

# op name -> {"cpu": plain, "cuda": launch, "fake": shapes}
IMPLS = {}

# the ops' registrations live as long as this library object; its kernels
# are plain Python functions on the CPU and CUDA dispatch keys (no
# autograd kernel in between: `torch.library.custom_op`'s wrappers cost
# ~15 µs of host time a call more)
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name, schema, cpu, cuda, fake):
    """Register ``paddle_tpu_torch::<name>`` with `schema` (its argument
    list and returns, in the dispatcher's syntax) and return the op."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    IMPLS[name] = {"cpu": cpu, "cuda": cuda, "fake": fake}
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def check_device(fn, t):
    """A wrapper's first check: the ops run on the CPU (plain) and on
    CUDA (the kernel); a tensor anywhere else raises before any work.
    A `static.Variable` (a ``meta`` tensor of a Program being recorded)
    passes: the op's call is recorded there, not run."""
    if t.device.type not in ("cpu", "cuda") \
            and not getattr(type(t), "_symbolic", False):
        raise ValueError(f"{fn}: unsupported device {t.device}")
