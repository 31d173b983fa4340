"""Hand-written CUDA kernels of the port (``paddle_tpu/ops/pallas``
counterpart).  Each module holds its kernels' wrappers, their plain
PyTorch versions, launch counters, CUDA sources and the TPU kernels they
replace.  `KERNELS` maps each kernel name to its `Kernel` record."""
from __future__ import annotations

from types import ModuleType
from typing import NamedTuple

from . import (
    conv_norm, decode_attention, flash_attention, fused_norm,
    paged_attention, relayout, rope, varlen_attention, window_attention,
)


class Kernel(NamedTuple):
    module: ModuleType
    wrapper: str      # the wrapper's name in `module`
    plain: str        # its plain version's name in `module`
    counter: str      # the module attribute counting its launches
    source: str       # its CUDA source, relative to the repository root
    replaces: str     # the TPU kernel it replaces (file:line)


KERNELS = {
    "flash_fwd": Kernel(flash_attention, "flash_fwd", "flash_fwd_reference",
                        "launches", flash_attention.SOURCE,
                        flash_attention.REPLACES),
    "flash_bwd": Kernel(flash_attention, "flash_bwd", "flash_bwd_reference",
                        "bwd_launches", flash_attention.BWD_SOURCE,
                        flash_attention.BWD_REPLACES),
    "paged_attention": Kernel(paged_attention, "paged_attention",
                              "paged_attention_reference", "launches",
                              paged_attention.SOURCE,
                              paged_attention.REPLACES),
    "decode_attention": Kernel(decode_attention, "decode_attention",
                               "decode_attention_reference", "launches",
                               decode_attention.SOURCE,
                               decode_attention.REPLACES),
    # one source and one wrapper, the direction on a counter of its own
    "rope": Kernel(rope, "rope", "rope_reference", "launches", rope.SOURCE,
                   rope.REPLACES),
    "rope_bwd": Kernel(rope, "rope", "rope_reference", "bwd_launches",
                       rope.SOURCE, rope.BWD_REPLACES),
    "conv_bn_act": Kernel(conv_norm, "conv_bn_act", "conv_bn_act_reference",
                          "launches", conv_norm.SOURCE, conv_norm.REPLACES),
    "window_attention": Kernel(window_attention, "window_attention",
                               "window_attention_reference", "launches",
                               window_attention.SOURCE,
                               window_attention.REPLACES),
    "window_attention_bwd": Kernel(window_attention, "window_attention_bwd",
                                   "window_attention_bwd_reference",
                                   "bwd_launches",
                                   window_attention.BWD_SOURCE,
                                   window_attention.BWD_REPLACES),
    # the packed mode of the flash sources, wrappers and counters of its own
    "varlen_fwd": Kernel(varlen_attention, "varlen_fwd",
                         "varlen_fwd_reference", "launches",
                         varlen_attention.SOURCE, varlen_attention.REPLACES),
    "varlen_bwd": Kernel(varlen_attention, "varlen_bwd",
                         "varlen_bwd_reference", "bwd_launches",
                         varlen_attention.BWD_SOURCE,
                         varlen_attention.BWD_REPLACES),
    "fused_norm": Kernel(fused_norm, "fused_norm", "fused_norm_reference",
                         "launches", fused_norm.SOURCE, fused_norm.REPLACES),
    # the int8 KV tier: one wrapper with the exact tier, a kernel and a
    # counter of its own
    "paged_attention_int8": Kernel(paged_attention, "paged_attention",
                                   "paged_attention_reference",
                                   "int8_launches", paged_attention.SOURCE,
                                   paged_attention.INT8_REPLACES),
    # the kv flash layout tier's relayouts: one source, a wrapper each
    "relayout_to_hm": Kernel(relayout, "to_head_major",
                             "to_head_major_reference", "to_launches",
                             relayout.SOURCE, relayout.TO_REPLACES),
    "relayout_from_hm": Kernel(relayout, "from_head_major",
                               "from_head_major_reference", "from_launches",
                               relayout.SOURCE, relayout.FROM_REPLACES),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        setattr(k.module, k.counter, 0)


def launch_counts() -> dict:
    return {name: getattr(k.module, k.counter)
            for name, k in KERNELS.items()}


def add_launches(counts: dict) -> None:
    """Add `counts` (kernel name -> launches) to the kernels' counters:
    a replayed CUDA graph launches its kernels without calling their
    wrappers (`core.graphs.Graph`)."""
    for name, n in counts.items():
        k = KERNELS[name]
        setattr(k.module, k.counter, getattr(k.module, k.counter) + n)
