"""Helpers shared by the port's op modules (``ops/creation.py`` ...
``ops/extra.py``): the amp gate by op name, argument conversion, the
index dtype, and the in-place write-back."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..amp import gate as _amp

# Paddle's index dtype.  The JAX package gives int32 (x64 off); the port
# keeps int64 (C2.40).
I64 = torch.int64


def gated(name):
    """Wrap an op so that its positional tensor arguments pass the amp
    gate under the JAX op name `name` (the JAX dispatch gate casts every
    op by name; C2.18), and its output is counted by the op stats."""
    def deco(f):
        @functools.wraps(f)
        def g(*args, **kw):
            return _amp.seen(name, f(*_amp.cast(name, *args), **kw))

        return g

    return deco


def tensor(x, like=None, dtype=None):
    """`x` as a tensor: a tensor stays (cast to `dtype` if given);
    anything else is made on `like`'s device (the CPU without one)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    dev = like.device if isinstance(like, torch.Tensor) else None
    if dtype is None and isinstance(x, float) and isinstance(
            like, torch.Tensor) and like.is_floating_point():
        dtype = like.dtype
    return torch.as_tensor(np.asarray(x) if isinstance(x, (list, tuple))
                           else x, dtype=dtype, device=dev)


def pair(x, y):
    """Both operands of a binary op as tensors: a Python number is made
    on the other's device."""
    if not isinstance(x, torch.Tensor):
        x = tensor(x, y)
    if not isinstance(y, torch.Tensor):
        y = tensor(y, x)
    return x, y


def scalar(x):
    """A Python number from a number or a one-element tensor."""
    return x.item() if isinstance(x, torch.Tensor) else x


def ints(xs):
    """A list of ints from ints, a tensor, or a sequence of either."""
    if isinstance(xs, torch.Tensor):
        return [int(v) for v in xs.reshape(-1).tolist()]
    if isinstance(xs, (int, np.integer)):
        return [int(xs)]
    return [int(scalar(v)) for v in xs]


def axes(axis):
    """Paddle's `axis` (None, an int, a list) as torch's `dim`."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def write(x, out):
    """The in-place form: `out` written into `x`, which is returned.

    The JAX package rebinds the handle, so a leaf that requires grad
    takes it there; torch refuses an in-place write into such a leaf and
    raises (ROADMAP C2.45).  A change of shape or dtype rebinds the
    tensor's data as JAX's rebind does (the history of `x` is not
    carried: a torch tensor cannot become another's graph node)."""
    if tuple(out.shape) == tuple(x.shape) and out.dtype == x.dtype:
        return x.copy_(out)
    x.data = out.detach().to(x.device)
    return x
