"""Paddle's top-level helpers (``paddle_tpu/__init__.py:19-393``
counterpart), resolved by ``paddle_tpu_torch.__getattr__`` at first
use: the dtype names, autograd switches and `grad`, the random state,
the places and build queries, and the small tensor helpers defined in
the JAX package's ``__init__``."""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import rng as _rng
from .device import resolve_device
from .dtypes import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, finfo, float16, float32,
    float64, get_default_dtype, iinfo, int8, int16, int32, int64,
    set_default_dtype, uint8,
)
from .flags import get_flags, set_flags  # noqa: F401
from ..ops._common import gated

__all__ = [
    "CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "LazyGuard", "TPUPlace",
    "Tensor", "apply", "batch", "bfloat16", "bool", "bool_", "check_shape",
    "column_stack", "complex128", "complex64", "device_count",
    "disable_signal_handler", "dtype", "enable_grad", "finfo", "float16",
    "float32", "float64", "get_cuda_rng_state", "get_cudnn_version",
    "get_default_dtype", "get_flags", "get_rng_state", "grad", "iinfo",
    "int16", "int32", "int64", "int8", "is_compiled_with_cuda",
    "is_compiled_with_rocm", "is_compiled_with_tpu",
    "is_compiled_with_xpu", "is_grad_enabled", "no_grad", "op", "pdist",
    "randint_like", "row_stack", "seed", "set_cuda_rng_state",
    "set_default_dtype", "set_flags", "set_grad_enabled",
    "set_printoptions", "set_rng_state", "synchronize",
    "tensor_method_grad_fix", "uint8", "unfold", "version",
]
__version__ = "0.1.0"

dtype = torch.dtype
bool = torch.bool  # noqa: A001  (paddle.bool)
Tensor = torch.Tensor


# --- autograd ----------------------------------------------------------------

def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """Gradients of `outputs` with respect to `inputs`, leaving `.grad`
    untouched (JAX ``core/engine.py:307``): a list, None for an unused
    input when `allow_unused`; `grad_outputs` default to ones."""
    outputs = [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)
    inputs = [inputs] if isinstance(inputs, torch.Tensor) else list(inputs)
    if grad_outputs is None:
        grad_outputs = [torch.ones_like(o) for o in outputs]
    elif isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    return list(torch.autograd.grad(outputs, inputs, grad_outputs,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=allow_unused))


class _NoGrad:
    """paddle.no_grad: a context manager (``with no_grad:`` or ``with
    no_grad():``) and a decorator (``@no_grad()`` or ``@no_grad``)."""

    def __call__(self, fn=None):
        if fn is None:
            return torch.no_grad()

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with torch.no_grad():
                return fn(*a, **kw)

        return wrapper

    def __enter__(self):
        self._cm = torch.no_grad()
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


no_grad = _NoGrad()
enable_grad = torch.enable_grad


def is_grad_enabled():
    return torch.is_grad_enabled()


def set_grad_enabled(mode):
    return torch.set_grad_enabled(mode)


# --- random state (core/rng.py; JAX core/rng.py:107-117) ---------------------

def seed(s):
    """Seed every device's generator of the port, and torch's own, with
    `s`: a run repeats itself from one call.  Returns the CPU
    generator."""
    _rng.seed(int(s))
    torch.manual_seed(int(s))
    return _rng.generator("cpu")


def get_rng_state(device=None):
    """[the state of the default (or `device`'s) generator]."""
    return [_rng.get_rng_state(resolve_device(device))]


def set_rng_state(states, device=None):
    _rng.set_rng_state(states[0] if isinstance(states, (list, tuple))
                       else states, resolve_device(device))


get_cuda_rng_state = get_rng_state
set_cuda_rng_state = set_rng_state


# --- places and the build ----------------------------------------------------

class CPUPlace:
    def __repr__(self):
        return "Place(cpu)"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace:
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"Place(gpu:{self.device_id})"

    def torch_device(self):
        return torch.device("cuda", self.device_id)


class TPUPlace(CUDAPlace):
    """Accepted for code written against the JAX package; the card's
    place here."""


class CUDAPinnedPlace(CPUPlace):
    pass


class version:
    """paddle.version."""

    full_version = __version__
    major, minor, patch = (__version__.split(".") + ["0", "0"])[:3]
    rc = "0"
    cuda_version = str(torch.version.cuda)
    cudnn_version = str(torch.backends.cudnn.version())
    tpu = False

    @staticmethod
    def show():
        print(f"paddle_tpu_torch {__version__} (PyTorch {torch.__version__}"
              f", CUDA {torch.version.cuda})")

    @staticmethod
    def cuda():
        return str(torch.version.cuda)

    @staticmethod
    def cudnn():
        return str(torch.backends.cudnn.version())


def device_count():
    return torch.cuda.device_count()


def synchronize():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def is_compiled_with_cuda():
    return torch.version.cuda is not None


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_tpu():
    return False


def get_cudnn_version():
    return torch.backends.cudnn.version()


# --- dispatch (JAX core/dispatch.py) ----------------------------------------

def apply(name, fn, *args):
    """`fn(*args)`: the port's tensors are torch's, so an op body runs
    as it is."""
    return fn(*args)


def op(name):
    """An op body under Paddle name `name`: its tensor arguments pass
    the amp gate (C2.18)."""
    return gated(name)


# --- helpers of the JAX __init__ (:256-393) ----------------------------------

class LazyGuard:
    """Paddle's LazyGuard delays parameter creation; parameters are
    made at once here, so the guard does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def randint_like(x, low=0, high=None, dtype=None, name=None):
    from ..ops.creation import randint

    return randint(low, high, shape=list(x.shape), dtype=dtype or x.dtype,
                   place=x.device)


def batch(reader, batch_size, drop_last=False):
    """Legacy reader combinator (paddle.batch)."""
    def _gen():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return _gen


def pdist(x, p=2.0, name=None):
    """Condensed pairwise distances of rows (the upper triangle, flat)."""
    n = x.shape[0]
    d = x[:, None, :] - x[None, :, :]
    if p == 2.0:
        m = torch.sqrt(torch.sum(d * d, -1) + 1e-30)
    else:
        m = torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)
    iu = torch.triu_indices(n, n, 1, device=x.device)
    return m[iu[0], iu[1]]


def column_stack(x, name=None):
    cols = [t.reshape(-1, 1) if t.dim() == 1 else t for t in x]
    return torch.cat(cols, 1)


def row_stack(x, name=None):
    return torch.vstack(list(x))


def unfold(x, axis, size, step, name=None):
    """Sliding windows of `size` every `step` over `axis`, the window
    axis last (paddle.unfold, not nn.functional.unfold's im2col)."""
    return x.unfold(int(axis), int(size), int(step)).clone()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)
    kw = {k: v for k, v in dict(precision=precision, threshold=threshold,
                                edgeitems=edgeitems,
                                linewidth=linewidth).items()
          if v is not None}
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def disable_signal_handler():
    """Nothing to disable: the port installs no signal handler."""


def check_shape(x):
    return list(x.shape)


def tensor_method_grad_fix():  # pragma: no cover
    pass

