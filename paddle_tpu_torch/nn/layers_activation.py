"""Activation layers (``paddle_tpu/nn/layers_activation.py``
counterpart): each calls its functional with the arguments it was built
with, positional in the JAX layer's order or by keyword.  GELU defaults
to the erf form, as the JAX layer does; PReLU holds its slope as a
parameter (0.25 by default), RReLU draws its slopes only in training."""
from __future__ import annotations

import torch

from . import functional as F
from .initializer import Constant
from .layer_base import Layer

__all__ = [
    "ReLU", "ReLU6", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU", "GELU",
    "Silu", "Swish", "Mish", "Hardswish", "Hardsigmoid", "Hardtanh",
    "Hardshrink", "Softshrink", "Tanhshrink", "Softsign", "Softplus",
    "Softmax", "LogSoftmax", "LogSigmoid", "Sigmoid", "Tanh", "GLU",
    "Maxout", "RReLU", "ThresholdedReLU",
]


def _simple(name, fn, **defaults):
    """A layer class calling ``fn(x, **kw)``, kw the `defaults` updated by
    the constructor's positional (in `defaults`' order) and keyword
    arguments; other keywords (`name`) are dropped (JAX :18-35)."""

    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        merged = dict(defaults)
        keys = list(defaults)
        for i, a in enumerate(args):
            merged[keys[i]] = a
        for k, v in kwargs.items():
            if k in merged:
                merged[k] = v
        self._kw = merged

    def forward(self, x):
        return fn(x, **self._kw)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
LeakyReLU = _simple("LeakyReLU", F.leaky_relu, negative_slope=0.01)
ELU = _simple("ELU", F.elu, alpha=1.0)
SELU = _simple("SELU", F.selu)
CELU = _simple("CELU", F.celu, alpha=1.0)
GELU = _simple("GELU", F.gelu, approximate=False)
Silu = _simple("Silu", F.silu)
Swish = _simple("Swish", F.swish)
Mish = _simple("Mish", F.mish)
Hardswish = _simple("Hardswish", F.hardswish)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Hardtanh = _simple("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
Hardshrink = _simple("Hardshrink", F.hardshrink, threshold=0.5)
Softshrink = _simple("Softshrink", F.softshrink, threshold=0.5)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
Softsign = _simple("Softsign", F.softsign)
Softplus = _simple("Softplus", F.softplus, beta=1, threshold=20)
Softmax = _simple("Softmax", F.softmax, axis=-1)
LogSoftmax = _simple("LogSoftmax", F.log_softmax, axis=-1)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Tanh = _simple("Tanh", F.tanh)
GLU = _simple("GLU", F.glu, axis=-1)
Maxout = _simple("Maxout", F.maxout, groups=2, axis=1)
ThresholdedReLU = _simple("ThresholdedReLU", F.thresholded_relu,
                          threshold=1.0, value=0.0)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__(dtype=dtype, device=device)
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower = lower
        self.upper = upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training)
