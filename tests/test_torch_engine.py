"""The port's continuous-batching engine on the CPU, in float32.

Engine streams must equal the port's sequential greedy `generate()`
token for token (the engine's own contract, as in test_engine.py), and
the JAX engine's streams on the same weights.  Covered: ragged batches,
page-boundary crossings, chunked decode, eviction under a tight pool,
prefix-cache hits (warm prefill), eos, cancel, the loop thread, and a
few unit cases of the copied paging / prefix / scheduler modules.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.inference.engine import (
    EngineConfig, InferenceEngine, OutOfPages, PagePool, PrefixIndex,
    Scheduler, Sequence,
)
from paddle_tpu_torch.models.gpt import (
    GPTConfig, GPTForCausalLM, load_reference_state,
)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)


@pytest.fixture(scope="module")
def models():
    P.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    params, _ = jm.functional_state()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return jm, tm


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    ps = [rs.randint(0, 128, (n,)).astype(np.int32)
          for n in (3, 9, 17, 5, 12)]
    # two prompts sharing a 16-token prefix: the second admission hits
    # the prefix cache (warm prefill) at page sizes 4 and 8
    shared = rs.randint(0, 128, (16,)).astype(np.int32)
    ps += [np.concatenate([shared, rs.randint(0, 128, (n,)).astype(
        np.int32)]) for n in (3, 7)]
    return ps


@pytest.fixture(scope="module")
def refs(models, prompts):
    _, tm = models
    return [tm.generate(p[None], max_new_tokens=10).numpy()[0]
            for p in prompts]


def _assert_drained(eng):
    st = eng.pool.stats()
    assert st["logical_pages"] == st["used"], st
    eng.clear_prefix_cache()
    assert eng.pool.used_pages == 0, eng.pool.stats()


def _run(eng, handles):
    idle = 0
    while any(not h.done.is_set() for h in handles):
        idle = 0 if eng.step() else idle + 1
        assert idle < 1000, "engine stalled"


def test_engine_matches_jax_engine(models, prompts, refs):
    jm, tm = models
    cfg = dict(page_size=4, max_slots=2, max_seq_len=64)
    jouts = JEngine(jm, JEngineConfig(**cfg)).generate(prompts,
                                                       max_new_tokens=10)
    eng = InferenceEngine(tm, EngineConfig(**cfg))
    outs = eng.generate(prompts, max_new_tokens=10)
    for j, o, r in zip(jouts, outs, refs):
        np.testing.assert_array_equal(o, j)
        np.testing.assert_array_equal(o, r)
    assert eng.prefix_cache_stats()["hits"] >= 1   # warm prefill ran
    _assert_drained(eng)


@pytest.mark.parametrize("page_size,slots,chunk", [
    (4, 2, 1),     # tiny pages: every sequence crosses many boundaries
    (8, 3, 4),     # chunked decode
    (16, 5, 8),    # whole batch resident, big chunks
])
def test_engine_matches_sequential_generate(models, prompts, refs,
                                            page_size, slots, chunk):
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(
        page_size=page_size, max_slots=slots, decode_chunk=chunk,
        max_seq_len=64))
    outs = eng.generate(prompts, max_new_tokens=10)
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)
    _assert_drained(eng)


def test_engine_page_boundary_exact_crossings(models):
    _, tm = models
    ps = [np.arange(1, n + 1, dtype=np.int32) % 127 + 1
          for n in (4, 8, 3, 5)]       # 4 and 8 fill whole pages
    refs = [tm.generate(p[None], max_new_tokens=9).numpy()[0] for p in ps]
    eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=4,
                                           max_seq_len=64))
    for r, o in zip(refs, eng.generate(ps, max_new_tokens=9)):
        np.testing.assert_array_equal(o, r)


def test_engine_eviction_recompute_identical(models, prompts, refs):
    """A pool too small for the batch forces mid-flight eviction; the
    preempted sequence re-prefills prompt + generated and continues."""
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(
        page_size=4, max_slots=2, num_pages=10, max_seq_len=64))
    for r, o in zip(refs, eng.generate(prompts, max_new_tokens=10)):
        np.testing.assert_array_equal(o, r)
    _assert_drained(eng)


def test_engine_prefix_cache_off_matches(models, prompts, refs):
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=3,
                                           max_seq_len=64,
                                           prefix_cache=0))
    for r, o in zip(refs, eng.generate(prompts, max_new_tokens=10)):
        np.testing.assert_array_equal(o, r)
    assert eng.prefix_cache_stats()["hits"] == 0


def test_engine_eos_matches_generate(models, prompts):
    _, tm = models
    eos = int(tm.generate(prompts[1][None], max_new_tokens=4)[0, -2])
    refs = [tm.generate(p[None], max_new_tokens=10,
                        eos_token_id=eos).numpy()[0] for p in prompts]
    eng = InferenceEngine(tm, EngineConfig(page_size=8, max_slots=3,
                                           decode_chunk=4, max_seq_len=64))
    outs = eng.generate(prompts, max_new_tokens=10, eos_token_id=eos)
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)
    assert any(len(o) < len(p) + 10 for o, p in zip(outs, prompts))


def test_engine_cancel_and_continuous_admission(models, prompts, refs):
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(page_size=8, max_slots=2,
                                           max_seq_len=64))
    first = [eng.submit(p, max_new_tokens=10) for p in prompts[:3]]
    for _ in range(2):
        eng.step()
    assert eng.cancel(first[1].request_id)
    late = [eng.submit(p, max_new_tokens=10) for p in prompts[3:]]
    _run(eng, first + late)
    assert first[1].cancelled
    for i, h in enumerate(first + late):
        if i != 1:
            np.testing.assert_array_equal(h.result(timeout=1.0), refs[i])
    assert eng._handles == {}
    _assert_drained(eng)


def test_engine_defrag_mid_flight_preserves_streams(models, prompts, refs):
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=3,
                                           max_seq_len=64))
    handles = [eng.submit(p, max_new_tokens=10) for p in prompts[:3]]
    for _ in range(2):
        eng.step()
    eng.cancel(handles[0].request_id)
    eng.step()
    assert eng.defrag() >= 0
    _run(eng, handles[1:])
    for i in (1, 2):
        np.testing.assert_array_equal(handles[i].result(timeout=1.0),
                                      refs[i])


def test_engine_loop_thread_serves(models, prompts, refs):
    """start(): the loop thread enters inference mode itself (grad mode
    is thread-local) and serves concurrent submissions."""
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(page_size=8, max_slots=3,
                                           max_seq_len=64)).start()
    try:
        handles = [eng.submit(p, max_new_tokens=10) for p in prompts]
        for h, r in zip(handles, refs):
            np.testing.assert_array_equal(h.result(timeout=60.0), r)
            assert list(h.stream(timeout=1.0)) == list(r[-10:])
    finally:
        eng.stop()
    assert eng.stats()["steps"] > 0


def test_engine_request_debug_names_eviction_stall(models, monkeypatch):
    """The per-request timeline and decision ring (as test_timeseries.py
    checks on the JAX engine): a pool too small for two sequences
    evicts the younger one, and its timeline's largest gap names it."""
    _, tm = models

    def tight():
        return InferenceEngine(tm, EngineConfig(
            page_size=4, max_slots=2, decode_chunk=1, prefill_bucket=4,
            max_seq_len=64, num_pages=11, prefix_cache=False))

    eng = tight()
    rs = np.random.RandomState(0)
    b_ids = rs.randint(0, 128, (8,)).astype(np.int32)   # 8+24 -> 8 pages
    a_ids = rs.randint(0, 128, (4,)).astype(np.int32)   # 4+24 -> 7 pages
    hb = eng.submit(b_ids, max_new_tokens=24, request_id="req-B")
    eng.step()
    ha = eng.submit(a_ids, max_new_tokens=24, request_id="req-A")
    _run(eng, [hb, ha])
    dbg = eng.request_debug("req-A")
    kinds = [e["kind"] for e in dbg["events"]]
    assert "evicted" in kinds and kinds.count("prefill_start") == 2
    assert dbg["tokens"] == 24
    # the gap that holds the eviction names it as its cause (which gap
    # is largest depends on host timing, so look at every reported gap)
    gap = next(g for g in dbg["gaps"]
               if any(e["kind"] == "evict_recompute" for e in g["events"]))
    evict = next(e for e in gap["events"] if e["kind"] == "evict_recompute")
    assert evict["request_id"] == "req-A"
    assert "evicted (recompute)" in gap["cause"] and "pool at" in gap["cause"]
    assert dbg["decision_ring_tail"]
    assert eng.request_debug("nope") is None
    assert eng.request_debug("req-B")["tokens"] == 24
    assert eng.recent_timelines()
    monkeypatch.setenv("PADDLE_TPU_ITL_TIMELINE_CAP", "0")
    eng2 = tight()
    h = eng2.submit(a_ids, max_new_tokens=2, request_id="req-off")
    _run(eng2, [h])
    assert eng2.request_debug("req-off") is None


def _tiny_gpt_pair(seed, vocab):
    """A JAX GPT of width 16 and the port's copy of it (draft models)."""
    cfg = dict(vocab_size=vocab, hidden_size=16, num_layers=1, num_heads=2,
               max_seq_len=64)
    P.seed(seed)
    jm = JGPT(JGPTConfig(**cfg))
    params, _ = jm.functional_state()
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return jm, tm


@pytest.mark.parametrize("knob", [
    dict(config=dict(weight_precision="int7"), match="int7"),
    dict(config=dict(spec_tokens=2), match="needs a draft_model"),
    dict(config={}, draft=128, match="spec_tokens == 0"),
    dict(config=dict(spec_tokens=2), draft=64, match="vocab_size"),
    dict(generate=dict(num_beams=2, do_sample=True), match="do_sample"),
    dict(generate=dict(num_beams=2, attention_mask=np.ones((1, 3))),
         match="left-padded"),
])
def test_engine_unported_tiers_raise(models, knob):
    """The weight tiers, speculative decoding, sampling and beam search
    are ported; what stays refused is what the JAX package refuses, with
    its ValueErrors: an unknown weight precision, spec_tokens without a
    draft, a draft without spec_tokens, a draft of another vocabulary,
    beam search with sampling or over left-padded prompts."""
    jm, tm = models
    match = knob["match"]
    if "generate" in knob:
        ids = np.zeros((1, 3), np.int32)
        with pytest.raises(ValueError, match=match):
            jm.generate(P.to_tensor(ids, "int32"), max_new_tokens=2,
                        **knob["generate"])
        with pytest.raises(ValueError, match=match):
            tm.generate(ids, max_new_tokens=2, **knob["generate"])
        return
    jd = td = None
    if "draft" in knob:
        jd, td = _tiny_gpt_pair(7, knob["draft"])
    with pytest.raises(ValueError, match=match):
        JEngine(jm, JEngineConfig(**knob["config"]), draft_model=jd)
    with pytest.raises(ValueError, match=match):
        InferenceEngine(tm, EngineConfig(**knob["config"]), draft_model=td)


def test_engine_config_not_mutated_and_sizes(models):
    _, tm = models
    cfg = EngineConfig(page_size=8, max_slots=2)
    eng = InferenceEngine(tm, cfg)
    assert cfg.max_seq_len == 0 and cfg.num_pages == 0
    assert eng.config.max_seq_len == 64
    assert eng.config.num_pages == 2 * 8 + 1
    assert eng._k_pools[0].shape == (17, 4, 8, 8)
    assert eng.stats()["page_bytes"] == 2 * 2 * 4 * 8 * 8 * 4


# ---------------- copied host modules (cases of test_engine.py) ----------

def test_page_pool_alloc_free_oom():
    pool = PagePool(num_pages=6, page_size=8)
    assert pool.capacity == 5          # page 0 reserved
    a = pool.alloc(3)
    assert len(set(a)) == 3 and 0 not in a
    with pytest.raises(OutOfPages):
        pool.alloc(3)
    assert pool.used_pages == 3
    pool.free(a)
    assert pool.used_pages == 0
    with pytest.raises(ValueError):
        pool.free([0])                 # scratch page


def test_prefix_index_lookup_insert_share():
    pool = PagePool(num_pages=10, page_size=4)
    idx = PrefixIndex(pool)
    toks = np.arange(1, 13, dtype=np.int32)
    pages = pool.alloc(3)
    assert idx.insert(toks, pages) == 3
    assert idx.cached_tokens == 12
    # the index holds its own reference on each committed page
    assert all(pool.refcount(p) == 2 for p in pages)
    shared, got, _ = idx.lookup(np.concatenate([toks[:8], [99, 98]]),
                                max_pages=8)
    assert shared == 8 and got == pages[:2]
    assert idx.lookup(np.asarray([5, 5, 5, 5]), max_pages=8)[0] == 0
    pool.free(pages)
    assert idx.clear() == 3 and pool.used_pages == 0


def test_scheduler_fifo_admission_and_eviction():
    clock = [0.0]
    pool = PagePool(num_pages=64, page_size=4)
    sch = Scheduler(2, pool, max_pages_per_seq=8, clock=lambda: clock[0])
    seqs = [Sequence(np.arange(1, 5, dtype=np.int32), 4, request_id=r)
            for r in "abc"]
    for s in seqs:
        sch.submit(s)
        clock[0] += 1.0
    out = sch.schedule()
    assert [s.request_id for s in out.prefills] == ["a", "b"]
    assert sch.waiting_sequences == 1
    pool = PagePool(num_pages=5, page_size=4)   # 4 allocatable pages
    sch = Scheduler(2, pool, max_pages_per_seq=4)
    a = Sequence(np.arange(1, 7, dtype=np.int32), 8, request_id="old")
    b = Sequence(np.arange(1, 7, dtype=np.int32), 8, request_id="young")
    sch.submit(a)
    sch.submit(b)
    assert len(sch.schedule().prefills) == 2
    a.length, b.length = 6, 6
    out = sch.schedule(chunk=4)
    assert [s.request_id for s in out.evicted] == ["young"]
    assert b.state == "waiting" and b.pages == []
