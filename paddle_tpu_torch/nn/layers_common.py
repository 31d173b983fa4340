"""Common layers (``paddle_tpu/nn/layers_common.py`` counterpart, with
`LayerNorm` / `RMSNorm` of ``layers_norm.py``): Linear, Embedding, the
dropouts, Flatten / Unflatten, Identity, the containers (Sequential,
LayerList, ParameterList, LayerDict), Upsample*, Pad*, CosineSimilarity,
PairwiseDistance, Bilinear, the pixel and channel shuffles, Fold /
Unfold and Softmax2D.

Each constructor takes the JAX layer's arguments (`weight_attr` /
`bias_attr`, False for none; `padding_idx`; `data_format`; `name`) and
the port's keywords `device` (None: the default of `core.device`, the
card unless `set_device` said otherwise), `dtype` and `generator`.
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
import threading
from collections import OrderedDict

import torch

from ..ops.quant import dequantize_channels
from . import functional as F
from .functional import dropout, dropout2d, dropout3d
from .initializer import Constant, Normal, XavierUniform
from .layer_base import Layer

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


class Linear(Layer):
    """``y = x @ weight + bias`` with weight ``[in, out]`` (JAX :22)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.linear(x, weight_in_use(self.weight), self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(Layer):
    """Rows of `weight` [num_embeddings, embedding_dim] (JAX :46); the
    row of `padding_idx` starts at zero and every lookup of it reads
    zero, so it gets no gradient.  `sparse` is accepted (the gradient is
    dense)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, ids):
        return F.common._zero_rows(weight_in_use(self.weight, ids), ids,
                                   self.padding_idx)


class Dropout(Layer):
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


class Dropout2D(Layer):
    """``layers_common.py:76``: whole channels dropped."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return dropout2d(x, self.p, training=self.training,
                         data_format=self.data_format)


class Dropout3D(Layer):
    """``layers_common.py:87``."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return dropout3d(x, self.p, training=self.training,
                         data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class LayerNorm(Layer):
    """Normalises over the trailing `normalized_shape` axes; unit weight
    and zero bias, either left out with False (JAX layers_norm.py:22)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(self.normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class RMSNorm(Layer):
    """``layers_norm.py:44``: a unit-initialised weight, no bias."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, None, self.epsilon)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        axis = self.axis % x.dim()
        return x.reshape(tuple(x.shape[:axis]) + tuple(self.shape)
                         + tuple(x.shape[axis + 1:]))


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Sequential(Layer):
    """Children named "0", "1", ... in order (or by the names of an
    OrderedDict or of (name, layer) pairs), so names read
    ``features.3.conv.1.0.weight`` as in the JAX package (JAX :125)."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """Children named "0", "1", ... (JAX :153)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx % len(self) if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self.add_sublayer(str(i), l)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self.add_sublayer(k, v)

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class _PadND(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        pad = self.padding if isinstance(self.padding, (list, tuple)) \
            else [self.padding] * 2
        return F.pad(x, pad, self.mode, self.value, self.data_format)


class Pad1D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        if isinstance(padding, int):
            padding = [padding, padding]
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        if isinstance(padding, int):
            padding = [padding] * 4
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        if isinstance(padding, int):
            padding = [padding] * 6
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Bilinear(Layer):
    """weight [out, in1, in2] (Xavier-uniform over its fans, as JAX
    :312), bias [out]."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class Softmax2D(Layer):
    """Softmax over the channel axis of NCHW input."""

    def forward(self, x):
        return F.softmax(x, axis=-3)
