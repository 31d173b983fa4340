"""paddle.save / paddle.load (``paddle_tpu/framework/io_utils.py``
counterpart) in the JAX package's file format.

A `.pdparams` file is a pickle of the object with every tensor replaced
by a `_TensorPayload`: its data as a numpy array and the JAX package's
name of its dtype (``"float32"``, ``"bfloat16"``, ...).  bfloat16 has no
numpy type without `ml_dtypes`, so its data travels as the raw uint16
words, as the JAX package writes it (:41-45).  Nested dicts, lists and
tuples keep their shape; other values pass through.

A pickle names the function that rebuilds a payload by its module.
`save` writes the JAX package's name, ``paddle_tpu.framework.io_utils``,
and `load` maps that name back to this module, so a file written by
either package loads in the other and neither imports the other (the
technique of ``distributed/checkpoint/_pickle.py``).

Loaded tensors land on the CUDA device unless the caller passes
``device="cpu"`` (or another device).
"""
from __future__ import annotations

import os
import pickle as _std
import types

import numpy as np
import torch

from ..core.device import resolve_device

_JAX_MODULE = "paddle_tpu.framework.io_utils"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def to_numpy(t) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16 as its uint16 words."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(data, bfloat16=False) -> torch.Tensor:
    """A CPU tensor of a copy of `data` (an unpickled array may be a
    read-only view of its bytes); with `bfloat16`, `data` holds the
    uint16 words of a bfloat16 tensor."""
    data = np.array(data)
    if bfloat16:
        return torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(data)


def _to_storable(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(to_numpy(obj), _dtype_name(obj.dtype))
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_storable(v) for v in obj)
    return obj


def _from_storable(obj, device):
    if isinstance(obj, _TensorPayload):
        return from_numpy(obj.data, obj.dtype == "bfloat16").to(device)
    if isinstance(obj, dict):
        return {k: _from_storable(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_storable(v, device) for v in obj)
    return obj


class _TensorPayload:
    __slots__ = ("data", "dtype")

    def __init__(self, data, dtype):
        # bfloat16 arrives as its uint16 words already
        self.data = data
        self.dtype = dtype

    def __reduce__(self):
        return (_restore_payload, (self.data, self.dtype))


def _restore_payload(data, dtype):
    p = object.__new__(_TensorPayload)
    p.data = data      # bfloat16: the uint16 words, read by _from_storable
    p.dtype = dtype
    return p


class _Pickler(_std._Pickler):
    """The pure-Python pickler, with `_restore_payload` saved under the
    JAX package's module name."""

    def save_global(self, obj, name=None):
        if obj is not _restore_payload:
            return super().save_global(obj, name)
        self.save(_JAX_MODULE)
        self.save(obj.__qualname__)
        self.write(_std.STACK_GLOBAL)
        self.memoize(obj)

    # functions go to `save_global` through the dispatch table, which
    # holds the base class's method
    dispatch = dict(_std._Pickler.dispatch)
    dispatch[types.FunctionType] = save_global


class _Unpickler(_std.Unpickler):
    def find_class(self, module, name):
        if module == _JAX_MODULE:
            module = __name__
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    """Write `obj` (a state dict, or any nesting of dicts, lists and
    tuples of tensors and plain values) to `path`."""
    if protocol < 4:
        raise ValueError(f"save: protocol {protocol}; the format needs "
                         "pickle protocol 4 or later")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_to_storable(obj))


def load(path, device=None, **configs):
    """Read a file `save` (or the JAX package's) wrote; its tensors on
    `device` (default: the CUDA device)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        return _from_storable(_Unpickler(f).load(), dev)
