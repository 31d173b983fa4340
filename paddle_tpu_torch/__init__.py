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
`inference.autoscaler`, `resilience`; slice 18); the engine's
quantized-weight and speculative tiers, sampling and beam search
(slice 19); the long job's train step: dropout, recompute, the step
guard, checkpoints, exact resume, watchdog and preemption (slice 20);
the eager training loop (slice 21): `optimizer` (the whole zoo, eager
``.step()`` and functional, parameter groups, ``grad_clip``,
``multi_precision``), `regularizer`, `amp` (`auto_cast` through a cast
gate, `decorate`, `GradScaler`; float16 through the flash kernels),
`cross_entropy`'s options, and `jit.to_static` in training; the
high-level loop and its files (slice 24): `save` / `load` in the JAX
package's format (`framework.io_utils`), `io` (datasets, samplers, the
`DataLoader` with shared-memory workers), `metric`, `hapi` (`Model`,
`summary`, `flops`) and `jit.save` / `jit.load` through `torch.export`,
with the kernels as custom ops inside the saved program; static programs
and saved-model serving (slice 25): `enable_static`, `static` (`data`,
`Program`, `Executor`, `save_inference_model` / `load_inference_model`,
the layer builders of `static.nn`), `inference.Config` /
`create_predictor` / `Predictor` and the C inference ABI
(`native/capi.py`), `InferenceServer(model_path=)` and fleet replicas of
kind ``model``; and Paddle's layer surface: `nn.Layer`,
`Parameter`, `ParamAttr`, the initializers, every `nn.functional`
function and `nn` layer of the JAX package (`nn.Transformer` and the
recurrent family with `BeamSearchDecoder` / `dynamic_decode` among
them), `nn.utils`, `nn.quant`, and `set_device` / `get_device`; and
Paddle's top-level op surface: the ops of `ops` (every name of
the JAX op table's public surface and each in-place twin), `linalg`,
`to_tensor`, `seed`, `grad`, `no_grad`, the dtype names and the places
(`core.surface`).

Top-level names resolve at first use (`__getattr__`): the package's
import stays light, since the DataLoader's worker processes import it.
"""
from __future__ import annotations

import importlib

__all__ = ["Model", "amp", "core", "disable_static", "distributed",
           "enable_static", "flops", "framework", "get_device", "hapi",
           "in_dynamic_mode", "incubate", "inference", "io", "jit", "linalg",
           "load", "metric", "models", "nn", "observability", "ops",
           "optimizer", "regularizer", "resilience", "save", "set_device",
           "static", "summary", "vision"]

# top-level names, imported at first use (the package's import stays
# light: the DataLoader's worker processes import it)
_LAZY = {"save": "framework.io_utils", "load": "framework.io_utils",
         "Model": "hapi.model", "summary": "hapi.summary",
         "flops": "hapi.summary", "enable_static": "static.recorder",
         "disable_static": "static.recorder",
         "in_dynamic_mode": "static.recorder",
         "set_device": "core.device", "get_device": "core.device",
         "Parameter": "nn.layer_base", "ParamAttr": "nn.layer_base"}
# Paddle's names for ops the port's ops package keeps under another
_RENAMED = {"shape": "shape_op"}


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name in _LAZY:
        obj = getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                      name)
    elif name in __all__:
        obj = importlib.import_module(f".{name}", __name__)
    else:
        surface = importlib.import_module(".core.surface", __name__)
        ops = importlib.import_module(".ops", __name__)
        if name in surface.__all__:
            obj = getattr(surface, name)
        elif _RENAMED.get(name, name) in ops.__all__:
            obj = getattr(ops, _RENAMED.get(name, name))
        else:
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = obj
    return obj
