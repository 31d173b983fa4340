"""Dtype names of the port: Paddle's dtype strings as torch dtypes
(``paddle_tpu/core/dtypes.py`` counterpart).

The JAX package runs with x64 off, so its `convert_dtype` demotes
int64 / float64 / uint64 / complex128 to their 32-bit types (:50-78).
The port keeps Paddle's 64-bit dtypes (ROADMAP C2.40): ``"int64"`` is
`torch.int64` here, and the index outputs of `arange`, `argmax`,
`nonzero`, ... are int64 where the JAX package gives int32.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "float64": float64, "complex64": complex64, "complex128": complex128,
    "fp16": float16, "fp32": float32, "fp64": float64,
}

_default_dtype = torch.float32


def torch_dtype(dtype, default=torch.float32) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name
    (``"float32"``, ``"int64"``, ``"bfloat16"``, ...); None -> `default`."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "").replace("torch.", "")
    if name == "bfloat16":
        return torch.bfloat16
    name = np.dtype(name).name
    got = getattr(torch, {"bool": "bool"}.get(name, name), None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"unsupported dtype {dtype!r}")
    return got


def convert_dtype(dtype):
    """A user's dtype (a Paddle name, a numpy or torch dtype) as a torch
    dtype; None stays None.  64-bit dtypes stay 64-bit (C2.40)."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("torch.", "")
        if key not in _STR2DTYPE:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return _STR2DTYPE[key]
    return torch_dtype(dtype)


def get_default_dtype():
    return _default_dtype


def set_default_dtype(dtype):
    global _default_dtype
    dtype = convert_dtype(dtype)
    if dtype not in (float16, bfloat16, float32, float64):
        raise TypeError(f"Default dtype must be floating, got {dtype}")
    _default_dtype = dtype


def _metadata_dtype(dtype):
    """The dtype a metadata query asks about, with no demotion."""
    if isinstance(dtype, torch.Tensor):
        return dtype.dtype
    return convert_dtype(dtype)


def iinfo(dtype):
    """`torch.iinfo` of an integer dtype (JAX ``__init__.py:175``
    returns `np.iinfo`: the same bits, min and max)."""
    return torch.iinfo(_metadata_dtype(dtype))


def finfo(dtype):
    """`torch.finfo` of a floating dtype, bfloat16 included (bits, eps,
    min, max, tiny, resolution as numpy's / ml_dtypes' give them)."""
    return torch.finfo(_metadata_dtype(dtype))
