"""Python side of the C inference ABI (``native/src/capi.cc``;
``paddle_tpu/inference/capi_bridge.py`` counterpart, :34-99).

The C library talks to this module only through (bytes, shape,
dtype-code) triples, so it never needs the NumPy C API: `capi.cc` packs
raw buffers into PyBytes and unpacks the returned triples back into
malloc'd C buffers.  Dtype code 6 (bfloat16) carries the raw 16-bit
words both ways, which is what a C program holds of a bfloat16 tensor;
on the Python side they are uint16 words (ROADMAP C2.32).

Handles are process-local integer ids (the C side takes the GIL on
every call, which guards the registry).  A predictor runs on the CUDA
device (card 0) unless ``PADDLE_TPU_CAPI_DEVICE`` names another:
``cpu`` or ``cuda:N`` (the ABI has no config calls of its own).
"""
from __future__ import annotations

import os

import numpy as np

# codes shared with paddle_tpu_torch.inference.DataType and capi.cc
_DTYPES = {
    0: np.float32,
    1: np.int64,
    2: np.int32,
    3: np.uint8,
    4: np.int8,
    5: np.float16,
    7: np.bool_,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_BF16_CODE = 6

_registry: dict = {}
_next_id = 1


def create(path_prefix: str) -> int:
    """Load a saved inference model; returns a handle (>0)."""
    global _next_id
    from . import Config, Predictor

    cfg = Config(path_prefix)
    dev = os.environ.get("PADDLE_TPU_CAPI_DEVICE", "")
    if dev == "cpu":
        cfg.disable_gpu()
    elif dev.startswith("cuda:"):
        cfg.enable_use_gpu(device_id=int(dev.split(":", 1)[1]))
    elif dev not in ("", "cuda"):
        raise ValueError(f"PADDLE_TPU_CAPI_DEVICE={dev!r}: expected cpu, "
                         "cuda or cuda:N")
    pred = Predictor(cfg)
    h = _next_id
    _next_id += 1
    _registry[h] = pred
    return h


def input_num(h: int) -> int:
    return len(_registry[h].get_input_names())


def output_num(h: int) -> int:
    return len(_registry[h].get_output_names())


def io_name(h: int, is_input: int, idx: int) -> str:
    pred = _registry[h]
    names = pred.get_input_names() if is_input else pred.get_output_names()
    return names[idx]


def _decode(triple):
    data, shape, code = triple
    if code == _BF16_CODE:
        arr = np.frombuffer(data, dtype=np.uint16)
    elif code in _DTYPES:
        arr = np.frombuffer(data, dtype=_DTYPES[code])
    else:
        raise ValueError(f"capi: unknown dtype code {code}")
    return arr.reshape(shape)


def _encode(out):
    """A predictor output (a tensor on its device) as a triple."""
    import torch

    from ..framework.io_utils import to_numpy

    code = _BF16_CODE if out.dtype == torch.bfloat16 else None
    arr = np.ascontiguousarray(to_numpy(out))
    if code is None:
        code = _CODES.get(arr.dtype)
        if code is None:  # e.g. float64: narrow
            arr = arr.astype(np.float32)
            code = 0
    return arr.tobytes(), tuple(int(s) for s in arr.shape), code


def run(h: int, inputs):
    """inputs: list of (bytes, shape-tuple, dtype-code). Returns the same
    triple format for every fetch output."""
    pred = _registry[h]
    for name, triple in zip(pred.get_input_names(), inputs):
        pred.get_input_handle(name).copy_from_cpu(_decode(triple))
    pred.run()
    return [_encode(pred.get_output_handle(n)._value)
            for n in pred.get_output_names()]


def destroy(h: int) -> int:
    return 1 if _registry.pop(h, None) is not None else 0
