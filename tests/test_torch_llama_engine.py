"""The port's LLaMA engine against `generate()` and the JAX engine, on
the CPU in float32 (``tests/test_torch_llama.py``'s `llama_tiny` pair
and prompts: ragged prompts, page crossings, a prefix-cache hit; other
page sizes, slot counts and decode chunks).  A file of its own so that
the tier-1 suite, one file to a worker, spreads over its workers.
"""
from __future__ import annotations

import numpy as np
import pytest

from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from test_torch_llama import _no_launches, models, prompts  # noqa: F401
import torch

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def refs(models, prompts):
    """Greedy `generate()` of each prompt alone, 8 new tokens."""
    _, tm = models
    return [tm.generate(p[None], max_new_tokens=8).numpy()[0]
            for p in prompts]


def test_engine_matches_generate_and_jax_engine(models, prompts, refs):
    jm, tm = models
    cfg = dict(page_size=4, max_slots=2, max_seq_len=64)
    jouts = JEngine(jm, JEngineConfig(**cfg)).generate(prompts,
                                                       max_new_tokens=8)
    eng = InferenceEngine(tm, EngineConfig(**cfg))
    assert eng._k_pools[0].shape[1] == 2          # kv heads, not 4
    outs = eng.generate(prompts, max_new_tokens=8)
    for j, o, r in zip(jouts, outs, refs):
        np.testing.assert_array_equal(o, r)
        np.testing.assert_array_equal(o, j)
    assert eng.prefix_cache_stats()["hits"] >= 1   # warm prefill ran


@pytest.mark.parametrize("page_size,slots,chunk", [(8, 3, 4), (16, 5, 1)])
def test_engine_matches_generate_other_pages(models, prompts, refs,
                                             page_size, slots, chunk):
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(page_size=page_size,
                                           max_slots=slots,
                                           decode_chunk=chunk,
                                           max_seq_len=64))
    for r, o in zip(refs, eng.generate(prompts, max_new_tokens=8)):
        np.testing.assert_array_equal(o, r)
