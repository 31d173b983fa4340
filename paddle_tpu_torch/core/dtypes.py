"""Dtype names of the port: Paddle's dtype strings as torch dtypes."""
from __future__ import annotations

import numpy as np
import torch


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
