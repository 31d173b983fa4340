"""The op layer of the port (``paddle_tpu/ops/__init__.py``
counterpart): Paddle's tensor ops as functions over torch tensors, with
Paddle's signatures (``axis=``, ``keepdim``, ``num_or_sections``, dtype
strings, ``name=``).

The JAX package patches its ops onto its `Tensor` as methods
(``ops/_patch.py``).  The port patches nothing onto `torch.Tensor`
(ROADMAP C2.41): a tensor's methods are torch's own, and every op here
is a function, ``paddle_tpu_torch.<op>(x, ...)``.  Each in-place form
``<op>_`` writes its result into its first argument and returns it
(C2.45).
"""
from __future__ import annotations

import builtins

import torch

from . import _op_table  # noqa: F401
from . import creation, extra, linalg, logic, manipulation, math, reduction
from ._common import write
from .creation import *  # noqa: F401,F403
from .extra import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .logic import is_tensor  # noqa: F401
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403


def add_n(inputs, name=None):
    """The sum of a list of tensors (JAX :23)."""
    if isinstance(inputs, torch.Tensor):
        return inputs
    vs = list(inputs)
    return builtins.sum(vs[1:], vs[0])


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the top-`k` scores, ties
    ordered as the JAX package's stable argsort orders them (:33)."""
    topk_idx = torch.sort(-input, dim=-1, stable=True).indices[:, :k]
    hit = torch.any(topk_idx == label.reshape(-1, 1), dim=-1)
    return torch.mean(hit.to(torch.float32))


def where_(condition, x, y, name=None):
    """`where` written into `x` (the reference's in-place target is `x`,
    not the condition)."""
    out = where(condition, x, y)  # noqa: F405
    return write(x, out) if isinstance(x, torch.Tensor) else out


# `nn.functional` holds the in-place twins of its activations
_FUNCTIONAL_TWINS = {"elu", "hardtanh", "leaky_relu", "relu", "softmax",
                     "thresholded_relu"}


def _in_place(base):
    fn = globals()[base]

    def g(x, *args, **kwargs):
        return write(x, fn(x, *args, **kwargs))

    g.__name__ = g.__qualname__ = base + "_"
    g.__doc__ = f"In-place form of `{base}`: its result written into x."
    return g


for _base in _op_table.INPLACE_OPS:
    if _base + "_" not in globals() and _base not in _FUNCTIONAL_TWINS:
        globals()[_base + "_"] = _in_place(_base)
del _base

# the op names, as the package's top level resolves them
__all__ = sorted({n for m in (creation, extra, linalg, logic, manipulation,
                              math, reduction) for n in m.__all__}
                 | {"add_n", "accuracy", "is_tensor", "where_"}
                 | {n + "_" for n in _op_table.INPLACE_OPS
                    if n + "_" in globals()})
