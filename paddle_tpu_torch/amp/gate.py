"""The cast gate of `auto_cast` (the role of the JAX package's
`_amp_hook` at its op-dispatch gate, ``paddle_tpu/amp/__init__.py``
:55-80, and of the op-stats sink of ``core/dispatch.py``).

The JAX package casts every op's tensor arguments at its dispatch gate,
by op name.  The port's layers call torch directly, so the entry points
of the listed ops call this gate under the JAX op names instead:
`Linear` ("linear"), the tied LM head ("matmul"),
`scaled_dot_product_attention`, `cross_entropy`, `layer_norm`,
`rms_norm`, `batch_norm` in training and `conv2d`.  Inside `auto_cast`
a white-listed op gets its floating arguments in the AMP dtype, a
black-listed one in f32, any other op keeps them;
``custom_white_list`` / ``custom_black_list`` move names between the
lists.  Outside `auto_cast` the gate returns its arguments as they are,
and the ops run as without it.

`debugging`'s operator-stats collection counts (op, output dtype) at
the gate, so it sees the gated ops only (the JAX package counts every
op).  Not a hook into torch: `torch.autocast` keeps its own lists, does
not know Paddle's op names, and does not reach kernels launched through
`ctypes`.
"""
from __future__ import annotations

import torch

# Per-op lists (the JAX package's, a subset of python/paddle/amp/
# amp_lists.py)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mv", "einsum",
    "addmm", "scaled_dot_product_attention",
}
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "c_softmax_with_cross_entropy", "cross_entropy", "layer_norm", "rms_norm",
    "group_norm", "instance_norm", "batch_norm", "l1_loss", "mse_loss",
    "logsumexp", "erfinv", "pow", "cumsum", "prod", "std", "var", "norm",
}


class _AmpState:
    enabled = False
    level = "O1"
    dtype = torch.bfloat16
    custom_white = frozenset()
    custom_black = frozenset()


state = _AmpState()
stats = None     # {(op name, dtype name): count} while collected


def op_dtype(name):
    """The dtype op `name` runs at under the current `auto_cast`, or
    None where it keeps its arguments' dtypes."""
    if not state.enabled:
        return None
    cw, cb = state.custom_white, state.custom_black
    if (name in WHITE_LIST or name in cw) and name not in cb:
        return state.dtype
    if (name in BLACK_LIST or name in cb) and name not in cw:
        return torch.float32
    return None


def cast(name, *xs):
    """`xs` as op `name` takes them under `auto_cast`: each floating
    tensor cast to the op's dtype; anything else as it is.  Returns a
    tuple."""
    dt = op_dtype(name)
    if dt is None:
        return xs
    return tuple(x.to(dt) if isinstance(x, torch.Tensor)
                 and x.is_floating_point() and x.dtype != dt else x
                 for x in xs)


def seen(name, out):
    """`out`, the output of op `name`, counted by its dtype while the
    operator stats are collected."""
    if stats is not None and isinstance(out, torch.Tensor):
        key = (name, str(out.dtype).replace("torch.", ""))
        stats[key] = stats.get(key, 0) + 1
    return out
