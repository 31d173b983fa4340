"""Default-device policy of the port's entry points.

Entry points (`GPTForCausalLM`, `InferenceEngine` through its model)
run on the CUDA device unless the caller names another device.  A host
without CUDA raises instead of quietly running on the CPU: a caller
that wants the plain CPU path (the tests) passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else -> ``torch.device(device)``.
    A CUDA device on a host without CUDA raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the CUDA device by default, and "
            "torch.cuda.is_available() is False on this host; pass "
            "device=\"cpu\" to run the plain PyTorch path on the CPU")
    return dev
