"""Default-device policy of the port's entry points.

Entry points (`GPTForCausalLM`, `InferenceEngine` through its model, the
`nn` layers) run on the CUDA device unless the caller names another
device.  A host without CUDA raises instead of quietly running on the
CPU: a caller that wants the plain CPU path (the tests) passes
``device="cpu"``, or says so once with ``set_device("cpu")``.

`set_device` / `get_device` are the counterparts of
``paddle_tpu/device/__init__.py:27-38`` (``paddle_tpu/__init__.py:126-134``).
The JAX pair records a name and places nothing by it; here the recorded
default is what `resolve_device(None)` returns (ROADMAP C2.35).  Unset,
the default is the card.
"""
from __future__ import annotations

import torch

# the device `resolve_device(None)` stands for, as set by `set_device`;
# None: the CUDA device
_default = None


def _parse(device) -> torch.device:
    """Paddle's device names (``"cpu"``, ``"gpu"``, ``"gpu:N"``) and
    torch's (``"cuda:N"``, a `torch.device`)."""
    if isinstance(device, torch.device):
        return device
    if hasattr(device, "torch_device"):      # CPUPlace(), CUDAPlace(i)
        return device.torch_device()
    name = str(device).lower()
    if name == "gpu" or name.startswith("gpu:"):
        name = "cuda" + name[3:]
    return torch.device(name)


def set_device(device):
    """Make `device` the default of every entry point that is given none:
    ``"cpu"``, ``"gpu"`` / ``"gpu:N"`` (``cuda:N``) or a torch device
    name.  Returns the device as Paddle names it (``"cpu"``,
    ``"gpu:N"``)."""
    global _default
    dev = _parse(device)
    _default = dev
    return get_device()


def get_device() -> str:
    """The default device as Paddle names it: ``"cpu"`` or ``"gpu:N"``
    (``"gpu:0"`` when none was set)."""
    dev = _default if _default is not None else torch.device("cuda")
    if dev.type == "cuda":
        return f"gpu:{dev.index or 0}"
    return dev.type


def resolve_device(device=None) -> torch.device:
    """``None`` -> the default (`set_device`'s, else ``cuda``); anything
    else -> that device.  A CUDA device on a host without CUDA raises
    RuntimeError."""
    if device is None:
        dev = _default if _default is not None else torch.device("cuda")
    else:
        dev = _parse(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the CUDA device by default, and "
            "torch.cuda.is_available() is False on this host; pass "
            "device=\"cpu\" (or call set_device(\"cpu\")) to run the "
            "plain PyTorch path on the CPU")
    return dev
