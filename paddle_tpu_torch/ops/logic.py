"""Comparison, logical and bitwise ops (``paddle_tpu/ops/logic.py``
counterpart)."""
from __future__ import annotations

import torch

from ._common import gated, pair

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "is_empty", "isin",
]


def _bin(name, f):
    @gated(name)
    def g(x, y, name=None):
        return f(*pair(x, y))

    g.__name__ = name
    return g


equal = _bin("equal", torch.eq)
not_equal = _bin("not_equal", torch.ne)
greater_than = _bin("greater_than", torch.gt)
greater_equal = _bin("greater_equal", torch.ge)
less_than = _bin("less_than", torch.lt)
less_equal = _bin("less_equal", torch.le)
logical_and = _bin("logical_and", torch.logical_and)
logical_or = _bin("logical_or", torch.logical_or)
logical_xor = _bin("logical_xor", torch.logical_xor)
bitwise_and = _bin("bitwise_and", torch.bitwise_and)
bitwise_or = _bin("bitwise_or", torch.bitwise_or)
bitwise_xor = _bin("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _bin("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _bin("bitwise_right_shift", torch.bitwise_right_shift)


@gated("logical_not")
def logical_not(x, name=None):
    return torch.logical_not(x)


@gated("bitwise_not")
def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


@gated("equal_all")
def equal_all(x, y, name=None):
    same = tuple(x.shape) == tuple(y.shape) and bool(torch.equal(x, y))
    return torch.tensor(same, device=x.device)


@gated("allclose")
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.all(torch.isclose(x, y, rtol, atol, equal_nan))


@gated("isclose")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol, atol, equal_nan)


@gated("is_empty")
def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


@gated("isin")
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(x, test_x, invert=invert)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
