"""Continuous-batching inference engine with a paged KV cache
(``paddle_tpu/inference/engine`` counterpart).

  * `paging`     — host page-pool allocator (copy of the JAX package's).
  * `prefix`     — radix prefix index (copy).
  * `scheduler`  — slot/admission/eviction policy (copy).
  * `engine`     — the `InferenceEngine`: bucketed dense prefill (cold)
                   or cached tail prefill (warm), pack-to-pages, ragged
                   paged decode steps through the `paged_attention`
                   CUDA kernel, request handles.
"""
from __future__ import annotations

from .engine import EngineConfig, InferenceEngine, RequestHandle  # noqa: F401
from .paging import OutOfPages, PagePool, SCRATCH_PAGE  # noqa: F401
from .prefix import PrefixIndex  # noqa: F401
from .scheduler import Scheduler, SchedulerOutput, Sequence  # noqa: F401

__all__ = [
    "EngineConfig", "InferenceEngine", "RequestHandle",
    "PagePool", "OutOfPages", "SCRATCH_PAGE", "PrefixIndex",
    "Scheduler", "SchedulerOutput", "Sequence",
]
