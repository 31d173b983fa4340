"""Draft-model speculative decoding of the port's engine on the CPU,
against the JAX engine and sequential greedy (``tests/test_quantized_
decode.py``'s cases, on ``tests/test_torch_quantized_decode.py``'s
models and fixtures): a random and an agreeing draft, eos and slot
reuse, eviction and recompute, a sequence that fills its page table (the
limit mask), a warm prefill of the draft, defrag.  A file of its own so
that the tier-1 suite, one file to a worker, spreads over its workers.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu_torch.observability as tobs
from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from paddle_tpu_torch.models.gpt import load_reference_state
from paddle_tpu_torch.observability import metrics as tmetrics
from test_torch_quantized_decode import (  # noqa: F401
    TARGET, _both, _drained, _equal, _pair, draft, prompts, refs, target,
)

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)


# ------------------------------------------------------------------ spec

def test_spec_random_draft_equals_jax_and_greedy(target, draft, prompts,
                                                  refs):
    """Any draft commits the target's greedy stream (JAX :362)."""
    jm, tm = target
    jd, td = draft
    want, got, eng = _both(jm, tm, prompts, jd=jd, td=td, page_size=8,
                           max_slots=3, max_seq_len=64, spec_tokens=3)
    _equal(want, got)
    _equal(refs, got)
    _drained(eng)
    assert eng.stats()["spec_tokens"] == 3 and eng.spec_passes > 0


def _agreeing(jm, tm):
    """A one-layer draft equal to the target's first layer, the target's
    second block zeroed to the identity (JAX :377, bench.py's draft):
    the draft proposes exactly the target's tokens."""
    jd, td = _pair(1, dict(TARGET, num_layers=1))
    jt = {n: p for n, p in jm.named_parameters()}
    for name, p in jd.named_parameters():
        p.set_value(jt[name]._value)
    blk = jm.gpt.h[1]
    for lin in (blk.attn.out_proj, blk.mlp.down_proj):
        lin.weight.set_value(np.zeros(lin.weight.shape, np.float32))
        lin.bias.set_value(np.zeros(lin.bias.shape, np.float32))
    for m, src in ((tm, jm), (td, jd)):
        params, _ = src.functional_state()
        load_reference_state(m, {k: np.asarray(v)
                                 for k, v in params.items()})
    return jd, td


def test_spec_agreeing_draft_accepts_and_equals_jax(prompts):
    jm, tm = _pair(0, TARGET)
    jd, td = _agreeing(jm, tm)
    refs = [tm.generate(p[None], max_new_tokens=10).numpy()[0]
            for p in prompts]
    tobs.attach(crash_hook=False)
    try:
        tmetrics.reset()
        tobs.attach(crash_hook=False)
        want, got, eng = _both(jm, tm, prompts, jd=jd, td=td, page_size=8,
                               max_slots=3, max_seq_len=64, spec_tokens=3)
        c = tmetrics.snapshot()["counters"]
        acc = c["engine.spec_decode{result=accepted}"]
        rej = c["engine.spec_decode{result=rejected}"]
    finally:
        tobs.detach()
    _equal(want, got)
    _equal(refs, got)
    # every proposal agrees; the "rejections" are the passes cut at a
    # sequence's end
    assert acc > 0 and acc >= 3 * rej, (acc, rej)
    _drained(eng)


@pytest.mark.parametrize("case", ["eos_slot_reuse", "eviction",
                                  "table_filling"])
def test_spec_streams_equal_jax(target, draft, prompts, case):
    """JAX :418, :433 and :447: the JAX engine's streams, which that
    file holds to sequential greedy.  `table_filling`: prompt + max_new
    fills the page table exactly and the passes overshoot the end, so
    rows past the limit must go to the scratch page, not onto the last
    live page."""
    jm, tm = target
    jd, td = draft
    eos = None
    new = 10
    if case == "eos_slot_reuse":
        cfg = dict(page_size=8, max_slots=2, max_seq_len=64, spec_tokens=4)
        eos = 7
    elif case == "eviction":
        cfg = dict(page_size=4, max_slots=2, num_pages=10, max_seq_len=64,
                   spec_tokens=3)
    else:
        cfg = dict(page_size=4, max_slots=2, max_seq_len=16, spec_tokens=4)
        rs = np.random.RandomState(11)
        prompts = [rs.randint(0, 128, (4,)).astype(np.int32),
                   rs.randint(0, 128, (3,)).astype(np.int32)]
    if case == "table_filling":
        je = JEngine(jm, JEngineConfig(**cfg), draft_model=jd)
        eng = InferenceEngine(tm, EngineConfig(**cfg), draft_model=td)
        want = [je.generate([p], max_new_tokens=16 - p.size)[0]
                for p in prompts]
        got = [eng.generate([p], max_new_tokens=16 - p.size)[0]
               for p in prompts]
    else:
        want, got, eng = _both(jm, tm, prompts, new=new, jd=jd, td=td,
                               eos=eos, **cfg)
    _equal(want, got)
    _drained(eng)


def test_spec_limit_mask_keeps_overflow_rows_on_scratch(target, draft):
    """One pass of the spec body over a slot 2 positions short of its
    limit: the rows at and past the limit write only scratch page 0, and
    no position at or past the limit of the slot's live pages changes;
    the rows below it write their own positions."""
    _, tm = target
    _, td = draft
    eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                           max_seq_len=16, spec_tokens=4),
                          draft_model=td)
    with torch.inference_mode():
        for t in eng._pool_tensors():
            t.copy_(torch.randn(t.shape))
        before = [t.clone() for t in eng._pool_tensors()]
        prog = eng._spec_program(4)
        pt = np.zeros((2, 4), np.int32)
        pt[0] = [1, 2, 3, 4]
        prog.pt.copy_(torch.from_numpy(pt))
        prog.tok.copy_(torch.tensor([5, 0], dtype=torch.int32))
        prog.lengths.copy_(torch.tensor([13, 0], dtype=torch.int32))
        prog.limits.copy_(torch.tensor([15, 0], dtype=torch.int32))
        eng._spec_body(prog)
        for a, b in zip(before, eng._pool_tensors()):
            changed = (a != b).reshape(a.shape[0], -1).any(-1)
            pages = set(np.flatnonzero(changed.numpy()).tolist())
            assert pages <= {0, 4}, pages
            # positions 13, 14 live on page 4 (slots 1, 2); 15 never
            if 4 in pages:
                slots = (a[4] != b[4]).any(-1).any(0).numpy()
                assert slots.tolist() == [False, True, True, False]
    assert int(prog.counts[1]) >= 1 and int(prog.counts[0]) >= 1


def test_spec_warm_prefill_and_defrag_equal_jax(target, draft):
    """Prefix-cache hits (the draft's warm prefill reads the donor's
    draft pages) and a defrag mid-flight that moves the draft's pools
    with the target's: streams equal the JAX engine's and greedy."""
    jm, tm = target
    jd, td = draft
    rs = np.random.RandomState(5)
    shared = rs.randint(0, 128, (16,)).astype(np.int32)
    # the second shared-prefix prompt is admitted after the first has
    # committed its prefix
    prompts = [rs.randint(0, 128, (6,)).astype(np.int32)] + [
        np.concatenate([shared, rs.randint(0, 128, (n,)).astype(np.int32)])
        for n in (3, 7)]
    cfg = dict(page_size=4, max_slots=2, max_seq_len=64, spec_tokens=3)
    want = JEngine(jm, JEngineConfig(**cfg), draft_model=jd).generate(
        prompts, max_new_tokens=9)
    eng = InferenceEngine(tm, EngineConfig(**cfg), draft_model=td)
    handles = [eng.submit(p, max_new_tokens=9) for p in prompts]
    moved = 0
    while any(not h.done.is_set() for h in handles):
        eng.step()
        moved += eng.defrag()
    got = [h.result() for h in handles]
    _equal(want, got)
    assert eng.prefix_cache_stats()["hits"] >= 1 and moved > 0
    assert {k for k in eng._prefills if k[1] is not None}
    _drained(eng)
