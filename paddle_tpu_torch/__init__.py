"""paddle_tpu_torch — the PyTorch + CUDA port of `paddle_tpu`, for NVIDIA
Hopper (H100).

The JAX package `paddle_tpu` stays the reference; this package mirrors
its module paths (``paddle_tpu/models/gpt.py`` ->
``paddle_tpu_torch/models/gpt.py``) and imports neither `jax` nor any
`paddle_tpu` module.  Every Pallas kernel on a ported path is a
hand-written CUDA kernel under ``csrc/``, built with `nvcc` at first use
and bound through `ctypes` (``ops/kernels/_build.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version, on a CUDA tensor it launches the kernel or raises.

Ported so far: the GPT serving path — `models.gpt`, greedy
`models.generation.generate`, and the continuous-batching
`inference.engine.InferenceEngine` over a paged KV cache (slice 1); the
single-device train step, `distributed.build_train_step` with
`optimizer.AdamW` (slice 2); the LLaMA family, `models.llama`, served
and trained through the same entry points (slice 3); vision inference,
`vision.models` ResNet / MobileNetV2 / Swin (slice 4), and their train
step (slice 5); packed attention, `nn.functional.flash_attn_unpadded`,
and the fused transformer blocks of `incubate.nn` over the fused norm
(slice 6); the role of `jax.jit` as CUDA graphs (`core.graphs`: the
engine's decode and prefill programs, the train step, `generate()`'s
decode chunks, and `jit.to_static`; slices 15-16); the serving plane
(`inference.serving`, `inference.router`, `inference.fleet`,
`inference.autoscaler`, `resilience`; slice 18).
"""
from __future__ import annotations

__all__ = ["core", "incubate", "inference", "jit", "models", "nn",
           "observability", "ops", "vision"]
