"""Hand-written CUDA kernels of the port (``paddle_tpu/ops/pallas``
counterpart).  Each module holds one kernel's wrapper, its plain PyTorch
version, its launch counter (`launches`), its source (`SOURCE`) and the
TPU kernel it replaces (`REPLACES`).  `KERNELS` maps each kernel name to
(module, wrapper name, plain-version name)."""
from __future__ import annotations

from . import decode_attention, flash_attention, paged_attention

KERNELS = {
    "flash_fwd": (flash_attention, "flash_fwd", "flash_fwd_reference"),
    "paged_attention": (paged_attention, "paged_attention",
                        "paged_attention_reference"),
    "decode_attention": (decode_attention, "decode_attention",
                         "decode_attention_reference"),
}


def reset_launches() -> None:
    for mod, _, _ in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, (mod, _, _) in KERNELS.items()}
