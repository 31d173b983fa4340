"""static.nn: program-building layer helpers, the layer builders
(``paddle_tpu/static/nn.py`` counterpart: `fc` :13, `embedding` :31,
`conv2d` :39, `batch_norm` :54, `layer_norm` :67, `_act` :78).

Each helper instantiates the eager layer (parameters materialize at
once, on `device`: the CUDA device unless given) and calls it on the
symbolic Variable, so its forward records into the Program.  `conv2d`
then `batch_norm` then an activation record the composed ops (a
convolution, the batch norm, the activation), as the JAX builders do:
the fused `conv_bn_act` kernel is the vision models' route
(`vision/models/_fused.py`), which reads the modules themselves.

`batch_norm` records inference-mode batch norm (``is_test=True``, or
``use_global_stats=True``).  In training mode it raises
NotImplementedError: its running statistics are an update, which
belongs to the static training slice (the JAX builder fails there too,
with a TypeError, updating its statistics from a symbolic value).
The other builders of the JAX module and its control flow (`cond`,
`case`, `switch_case`, `while_loop`, `static_pylayer`, `py_func`) wait
for that slice (ROADMAP).
"""
from __future__ import annotations

import numpy as np

from ..core.device import resolve_device
from .framework import torch_dtype

__all__ = ["batch_norm", "conv2d", "embedding", "fc", "layer_norm"]

def _act(out, act):
    """`act` by its Paddle name: the port's functional of that name."""
    if not act:
        return out
    from ..nn import functional as F

    fn = getattr(F, act, None)
    if fn is None:
        raise ValueError(f"static.nn: unknown activation {act!r}")
    return fn(out)


def fc(x, size, num_flatten_dims=1, activation=None, name=None,
       weight_attr=None, bias_attr=None, device=None):
    from .. import nn

    decl = getattr(x, "declared_shape", None) or list(x.shape)
    if any(d == -1 for d in decl[num_flatten_dims:]):
        raise ValueError("fc: flattened dims must be static")
    in_dim = int(np.prod(decl[num_flatten_dims:]))
    layer = nn.Linear(in_dim, size, weight_attr, bias_attr,
                      device=resolve_device(device), dtype=x.dtype)
    flat = x
    if len(decl) > num_flatten_dims + 1:
        flat = x.reshape(-1, in_dim)
    return _act(layer(flat), activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              dtype="float32", param_attr=None, device=None):
    from .. import nn

    layer = nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                         weight_attr=param_attr,
                         device=resolve_device(device),
                         dtype=torch_dtype(dtype))
    return layer(input)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", device=None):
    from .. import nn

    in_ch = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    layer = nn.Conv2D(in_ch, num_filters, filter_size, stride=stride,
                      padding=padding, dilation=dilation, groups=groups,
                      weight_attr=param_attr, bias_attr=bias_attr,
                      data_format=data_format,
                      device=resolve_device(device), dtype=input.dtype)
    return _act(layer(input), act)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               data_layout="NCHW", use_global_stats=None, device=None,
               **kwargs):
    from .. import nn

    if not (is_test or use_global_stats):
        raise NotImplementedError(
            "static.nn.batch_norm in training mode updates its running "
            "statistics, an update the static training slice records; "
            "pass is_test=True for an inference program")
    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = nn.BatchNorm2D(ch, momentum=momentum, epsilon=epsilon,
                           data_format=data_layout,
                           device=resolve_device(device), dtype=input.dtype)
    layer.eval()
    return _act(layer(input), act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, device=None, **kwargs):
    from .. import nn

    shape = [int(s) for s in input.shape[begin_norm_axis:]]
    layer = nn.LayerNorm(shape, epsilon=epsilon,
                         device=resolve_device(device), dtype=input.dtype)
    return layer(input)
