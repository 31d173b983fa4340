"""Linear / Embedding / the dropouts / LayerNorm / RMSNorm / Sequential /
LayerList (counterparts of
``paddle_tpu/nn/layers_common.py`` and ``layers_norm.py``).

Parameter layouts follow Paddle, so names and shapes line up one to one
with the JAX package's ``functional_state()``: `Linear.weight` is
``[in_features, out_features]``.  Initialisers follow Paddle's defaults
(Xavier-uniform Linear weights, N(0, 1) embeddings, zero biases, unit
norm weights), drawn from the caller's `torch.Generator` on the
parameter's device.

`Linear`, `Embedding` and the tied LM heads of the model families read
their weight through `weight_in_use`: inside `weights_in_use(stored)`
a weight that `stored` holds in a narrow form (the serving engine's
int8 and bf16 weight tiers) is dequantized where it is used, just
before its matmul or lookup, so no full-precision copy of the model is
ever made at once.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn

from ..ops.quant import dequantize_channels
from .functional import dropout, dropout2d, dropout3d, layer_norm, rms_norm

# {parameter: (stored, scales or None, dtype)} of the current thread's
# `weights_in_use`, or None.  Thread-local, as `warm_prefill_guard`: a
# CUDA graph's capture records the dequantization of the body it runs.
_IN_USE = threading.local()


@contextlib.contextmanager
def weights_in_use(stored):
    """Layers called inside read each parameter that `stored` maps to
    ``(q, scales, dtype)`` as `dequantize_channels(q, scales, dtype)`
    (int8 codes with per-channel f32 scales), or as ``q.to(dtype)`` when
    scales is None (a plain cast).  An embedding's scales are per row
    ([num_embeddings, 1]).  An empty `stored` changes nothing."""
    prev = getattr(_IN_USE, "value", None)
    _IN_USE.value = stored or None
    try:
        yield
    finally:
        _IN_USE.value = prev


def weight_in_use(param, rows=None):
    """The weight a layer computes with: `param`, or its stored form
    dequantized here under `weights_in_use`.  With `rows` (a lookup's
    ids) only those rows, dequantized after the gather."""
    stored = getattr(_IN_USE, "value", None)
    entry = None if stored is None else stored.get(param)
    if entry is None:
        return param if rows is None else param[rows]
    q, scales, dtype = entry
    if rows is not None:
        q = q[rows]
        scales = None if scales is None else scales[rows]
    if scales is None:
        return q.to(dtype)
    return dequantize_channels(q, scales, dtype)


def _param(t):
    # trainable; the serving entries run under torch.inference_mode(), so
    # serving builds no autograd graph
    return nn.Parameter(t)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with weight ``[in, out]``."""

    def __init__(self, in_features, out_features, bias=True, *, device,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features, device=device,
                        dtype=dtype)
        w.uniform_(-limit, limit, generator=generator)
        self.weight = _param(w)
        self.bias = _param(torch.zeros(out_features, device=device,
                                       dtype=dtype)) if bias else None

    def forward(self, x):
        y = torch.matmul(x, weight_in_use(self.weight))
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device,
                 dtype=torch.float32, generator=None):
        super().__init__()
        w = torch.empty(num_embeddings, embedding_dim, device=device,
                        dtype=dtype)
        w.normal_(0.0, 1.0, generator=generator)
        self.weight = _param(w)

    def forward(self, ids):
        return weight_in_use(self.weight, ids)


class Dropout(nn.Module):
    """``layers_common.py:64``: `dropout` in training mode, with the
    layer's `axis` and `mode`; in eval mode the identity, or the scaling
    by 1 - p of ``downscale_in_infer``."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode)


class Dropout2D(nn.Module):
    """``layers_common.py:76``: whole channels dropped."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return dropout2d(x, self.p, training=self.training,
                         data_format=self.data_format)


class Dropout3D(nn.Module):
    """``layers_common.py:87``."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return dropout3d(x, self.p, training=self.training,
                         data_format=self.data_format)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.normalized_shape = normalized_shape
        self.epsilon = epsilon
        self.weight = _param(torch.ones(normalized_shape, device=device,
                                        dtype=dtype))
        self.bias = _param(torch.zeros(normalized_shape, device=device,
                                       dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.epsilon)


class RMSNorm(nn.Module):
    """``layers_norm.py:44``: a unit-initialised weight, no bias."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(torch.ones(hidden_size, device=device,
                                        dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, None, self.epsilon)


# ``layers_common.py:125`` and ``:153``: children named "0", "1", ... in
# order, so names read ``features.3.conv.1.0.weight`` as in the JAX package
Sequential = nn.Sequential
LayerList = nn.ModuleList
