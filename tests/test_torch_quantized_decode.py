"""The port's weight tiers and draft-model speculative decoding on the
CPU, against the JAX package (`tests/test_quantized_decode.py`'s cases).

The models are that file's fixtures: a GPT of vocab 128, width 32, two
layers, and a draft of width 16, one layer, in f32, their weights
carried from the JAX models' ``functional_state()``.  Tokens are
compared exactly (the port and the JAX package compute the same f32
greedy streams), codec outputs bit for bit.

  * the per-channel codec of the weight tiers (a ``[in, out]`` Linear
    weight over axis 0, a tied embedding over axis 1) against
    `paddle_tpu.ops.quant`;
  * the int8 and bf16 weight tiers: engine streams equal the JAX
    engine's and the port's own `generate()` over `effective_params()`;
    each weight dequantized where it is used, one at a time;
  * speculative decoding with a random and with an agreeing draft, eos
    and slot reuse, eviction and recompute, a sequence that fills its
    page table (the limit mask), a warm prefill of the draft, defrag:
    streams equal the JAX engine's and sequential greedy (in
    ``tests/test_torch_spec_decode.py``, a file of its own so that the
    suite spreads over its workers; it uses this file's fixtures);
  * all tiers composed, the schema, the gauges and stats, and the
    capture path of the spec program.
"""
from __future__ import annotations

import ast
import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models import llama as JL
from paddle_tpu.ops import quant as JQ
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.core import graphs as GR
from paddle_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from paddle_tpu_torch.inference.engine import engine as EN
from paddle_tpu_torch.models.gpt import (
    GPTConfig, GPTForCausalLM, load_reference_state,
)
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.nn import layers_common as LC
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.ops import quant as Q
from test_torch_graphs import _FakeCapture, _FakeCUDAGraph

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

TARGET = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64)
DRAFT = dict(vocab_size=128, hidden_size=16, num_layers=1, num_heads=2,
             max_seq_len=64)


def _pair(seed, cfg):
    """A JAX GPT seeded with `seed` and the port's copy of it."""
    P.seed(seed)
    jm = JGPT(JGPTConfig(**cfg))
    jm.eval()
    params, _ = jm.functional_state()
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return jm, tm


@pytest.fixture(scope="module")
def target():
    return _pair(0, TARGET)


@pytest.fixture(scope="module")
def draft():
    return _pair(7, DRAFT)


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 128, (n,)).astype(np.int32)
            for n in (3, 9, 17, 5, 12)]


@pytest.fixture(scope="module")
def refs(target, prompts):
    _, tm = target
    return [tm.generate(p[None], max_new_tokens=10).numpy()[0]
            for p in prompts]


def _drained(eng):
    st = eng.pool.stats()
    assert st["logical_pages"] == st["used"], st
    eng.clear_prefix_cache()
    assert eng.pool.used_pages == 0, eng.pool.stats()


def _both(jm, tm, prompts, new=10, jd=None, td=None, eos=None, **cfg):
    """The JAX engine's and the port's engine's outputs, and the port's
    engine, over one EngineConfig."""
    je = JEngine(jm, JEngineConfig(**cfg), draft_model=jd)
    want = je.generate(prompts, max_new_tokens=new, eos_token_id=eos)
    eng = InferenceEngine(tm, EngineConfig(**cfg), draft_model=td)
    got = eng.generate(prompts, max_new_tokens=new, eos_token_id=eos)
    return want, got, eng


def _equal(want, got):
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g), (np.asarray(w).tolist(),
                                                  g.tolist())


def _greedy_over(tm, params, prompts, new=10):
    """Plain `generate()` of a port model of tm's config with `params`
    loaded (the engine's `effective_params()`)."""
    m = GPTForCausalLM(tm.cfg, device="cpu")
    load_reference_state(m, {k: v.numpy() for k, v in params.items()})
    return [m.generate(p[None], max_new_tokens=new).numpy()[0]
            for p in prompts]


# ------------------------------------------------------------------ codec

@pytest.mark.parametrize("axis,shape", [(0, (32, 96)), (1, (128, 32))],
                         ids=["linear_axis0", "tied_embedding_axis1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_codec_bit_equal_to_jax(axis, shape, dtype):
    """The weight tiers' codec: codes and scales of a Linear weight over
    its input axis and of a tied embedding over its hidden axis, and the
    dequantization back into the weight's dtype, bit for bit JAX's
    (`ops/quant.py:98` / `:111`)."""
    rs = np.random.RandomState(axis)
    w = (rs.randn(*shape) * 0.2).astype(np.float32)
    w[:, 0] = 0.0                        # an all-zero input row / column
    w[0, 1] = 3.0                        # one outlier
    q, s = Q.quantize_channels(torch.from_numpy(w), axis=axis)
    jq, js = JQ.quantize_channels(jnp.asarray(w), axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape[axis] == 1
    got = Q.dequantize_channels(q, s, getattr(torch, dtype)).float()
    want = JQ.dequantize_channels(jq, js, getattr(jnp, dtype))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------------------ weight tiers

@pytest.mark.parametrize("prec", ["int8", "bf16"])
def test_weight_tier_streams_equal_jax_and_dequantized_greedy(
        target, prompts, prec):
    """The weight tier's contract (JAX :241, :267): the engine's streams
    equal the JAX engine's, and plain `generate()` over the weights the
    engine computes with (`effective_params()`); the model keeps its own
    weights."""
    jm, tm = target
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    want, got, eng = _both(jm, tm, prompts, page_size=8, max_slots=3,
                           decode_chunk=2, max_seq_len=64,
                           weight_precision=prec)
    _equal(want, got)
    _equal(_greedy_over(tm, eng.effective_params(), prompts), got)
    _drained(eng)
    # 4 Linears x 2 layers + the tied embedding, as in the JAX engine
    assert len(eng._wq) == 9
    assert "gpt.wte.weight" in eng._wq_names
    assert "gpt.wpe.weight" not in eng._wq_names
    for w, (q, s, dtype) in eng._wq.items():
        assert dtype == torch.float32
        if prec == "int8":
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            axis = 1 if w is tm.gpt.wte.weight else 0
            assert s.shape[axis] == 1 and s.shape[1 - axis] == w.shape[
                1 - axis]
        else:
            assert q.dtype == torch.bfloat16 and s is None
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())
    st = eng.stats()
    assert st["weight_precision"] == prec and st["spec_tokens"] == 0


def test_int8_weights_llama_equal_jax():
    """The LLaMA family (GQA 4/2, untied `lm_head` [hidden, vocab]: a
    Linear over axis 0, the embedding left exact) under the int8 weight
    tier: streams equal the JAX engine's."""
    P.seed(3)
    cfg = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
               num_kv_heads=2, max_seq_len=64, ffn_hidden=64)
    jm = JL.LlamaForCausalLM(JL.LlamaConfig(**cfg))
    jm.eval()
    params, _ = jm.functional_state()
    tm = TL.LlamaForCausalLM(TL.LlamaConfig(**cfg), device="cpu")
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (4, 11, 7)]
    want, got, eng = _both(jm, tm, prompts, new=8, page_size=8, max_slots=2,
                           max_seq_len=64, weight_precision="int8")
    _equal(want, got)
    assert "lm_head.weight" in eng._wq_names
    assert "model.embed_tokens.weight" not in eng._wq_names
    _drained(eng)


def test_weights_dequantized_where_used(target, monkeypatch):
    """The int8 tier never builds a full-precision model: inside one
    decode step each stored weight is dequantized once per use, just
    before its matmul (in the order the forward uses them), and the
    embedding lookup dequantizes only the rows it reads."""
    _, tm = target
    eng = InferenceEngine(tm, EngineConfig(page_size=8, max_slots=2,
                                           max_seq_len=64,
                                           weight_precision="int8"))
    seen, real = [], LC.dequantize_channels

    def spy(q, scales, dtype):
        seen.append(tuple(q.shape))
        return real(q, scales, dtype)

    monkeypatch.setattr(LC, "dequantize_channels", spy)
    order = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: order.append((name, len(seen))))
        for name, m in tm.named_modules() if isinstance(m, LC.Linear)]
    try:
        with torch.inference_mode():
            eng._run_decode(1, np.zeros(2, np.int32),
                            np.zeros((2, eng.max_pages_per_seq), np.int32),
                            np.zeros(2, np.int32))
    finally:
        for h in hooks:
            h.remove()
    # the lookup's rows [2, 1, 32], then 8 Linear weights, then the head
    assert seen[0] == (2, 1, 32)
    assert len(seen) == 1 + 8 + 1 and seen[-1] == (128, 32)
    # each Linear's weight is dequantized right after its call starts,
    # never all of them up front
    assert [n for _, n in order] == list(range(1, 9))
    assert not LC._IN_USE.__dict__.get("value")   # the override ended


def test_page_bytes_count_the_draft(target, draft):
    _, tm = target
    _, td = draft
    plain = InferenceEngine(tm, EngineConfig(page_size=8, max_seq_len=64))
    spec = InferenceEngine(tm, EngineConfig(page_size=8, max_seq_len=64,
                                            spec_tokens=2), draft_model=td)
    # the draft: 1 layer x K and V x 2 kv heads x 8 slots x 8 dims x 4 B
    assert spec._page_bytes() - plain._page_bytes() == 1 * 2 * 2 * 8 * 8 * 4
    budget = InferenceEngine(tm, EngineConfig(
        page_size=8, max_seq_len=64, spec_tokens=2, pool_hbm_mb=0.0625),
        draft_model=td)
    assert budget.config.num_pages == int(0.0625 * 2**20) \
        // spec._page_bytes()
    assert budget._draft["k_pools"][0].shape == (budget.config.num_pages,
                                                 2, 8, 8)


# ----------------------------------------------------------- composition

def test_all_tiers_compose_equal_jax_and_stable(target, draft, prompts):
    """int8 weights + int8 KV + spec in one engine (JAX :492): equal to
    the JAX engine's streams, and bit-stable run to run."""
    jm, tm = target
    jd, td = draft
    cfg = dict(page_size=8, max_slots=3, max_seq_len=64, spec_tokens=3,
               weight_precision="int8", kv_precision="int8")
    want, got, eng = _both(jm, tm, prompts, jd=jd, td=td, **cfg)
    _equal(want, got)
    _drained(eng)
    again = InferenceEngine(tm, EngineConfig(**cfg), draft_model=td) \
        .generate(prompts, max_new_tokens=10)
    _equal(got, again)


def test_spec_plus_int8_weights_equal_dequantized_greedy(target, draft,
                                                         prompts):
    """JAX :511: the spec stream over int8 weights is the greedy stream
    of the dequantized model."""
    _, tm = target
    _, td = draft
    eng = InferenceEngine(tm, EngineConfig(
        page_size=8, max_slots=3, max_seq_len=64, spec_tokens=3,
        weight_precision="int8"), draft_model=td)
    got = eng.generate(prompts, max_new_tokens=10)
    _equal(_greedy_over(tm, eng.effective_params(), prompts), got)


def test_schema_gauges_and_stats(target, draft):
    """`attach()` declares the spec counters and every weight tier's
    gauge (JAX :653); an engine publishes its tiers."""
    _, tm = target
    _, td = draft
    tobs.attach(crash_hook=False)
    try:
        tmetrics.reset()
        tobs.attach(crash_hook=False)
        snap = tmetrics.snapshot()
        c, g = snap["counters"], snap["gauges"]
        assert c["engine.spec_decode{result=accepted}"] == 0
        assert c["engine.spec_decode{result=rejected}"] == 0
        for p in ("full", "bf16", "int8"):
            assert g[f"engine.weight_precision{{precision={p}}}"] == 0
        assert g["engine.spec_tokens"] == 0
        eng = InferenceEngine(tm, EngineConfig(
            page_size=8, max_slots=2, max_seq_len=64, spec_tokens=2,
            weight_precision="int8", kv_precision="int8"), draft_model=td)
        g = tmetrics.snapshot()["gauges"]
        assert g["engine.weight_precision{precision=int8}"] == 1
        assert g["engine.spec_tokens"] == 2
    finally:
        tobs.detach()
    st = eng.stats()
    assert (st["weight_precision"], st["kv_precision"], st["spec_tokens"]) \
        == ("int8", "int8", 2)


# ------------------------------------------------------------ graph path

def _tree(fn):
    return ast.parse(textwrap.dedent(inspect.getsource(fn)))


def test_spec_program_capture_path_never_falls_back():
    """The rule `test_torch_graphs.py` holds the decode program to: the
    spec program's maker runs no body, its capture records one partial
    of `_spec_body` through `GR.capture` on the capture stream in the
    engine's pool, and `_run_spec` branches once, a CPU device to the
    body and anything else to the replay; the draft's prefill graphs
    take the JAX labels."""
    maker = _tree(EN.InferenceEngine._spec_program)
    assert "_body" not in ast.unparse(maker)
    cap = _tree(EN.InferenceEngine._capture_spec)
    text = ast.unparse(cap)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(cap))
    assert "cpu" not in text and "environ" not in text
    assert text.count("functools.partial(self._spec_body") == 1
    calls = [n for n in ast.walk(cap) if isinstance(n, ast.Call)
             and ast.unparse(n.func) == "GR.capture"]
    assert len(calls) == 1 and len(calls[0].args) == 3
    assert "pool" in [k.arg for k in calls[0].keywords]
    assert "GR.capture_stream(" in text
    run = _tree(EN.InferenceEngine._run_spec)
    ifs = [n for n in ast.walk(run) if isinstance(n, ast.If)]
    assert len(ifs) == 1
    assert ast.unparse(ifs[0].test) == "self._device.type == 'cpu'"
    assert ast.unparse(ast.Module(ifs[0].body, [])) == \
        "self._spec_body(prog)"
    assert ast.unparse(ast.Module(ifs[0].orelse, [])) == \
        "self._replay_decode(prog)"

    class _Prog:
        sb, npp = 32, 4

    eng = EN.InferenceEngine.__new__(EN.InferenceEngine)
    eng._quant = True
    assert eng._prefill_label(_Prog()) == "cprefill_s32_p4_q"
    assert eng._prefill_label(_Prog(), draft=True) == \
        "cprefill_s32_p4_draft"
    _Prog.npp = None
    assert eng._prefill_label(_Prog(), draft=True) == "prefill_s32_draft"


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_pauses_the_cyclic_collector(monkeypatch, enabled):
    """A capture runs with Python's cyclic collector off (a collection
    inside it could destroy an unreachable engine's graph, which fails a
    capture on the card), and the collector's state comes back after."""
    import gc

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)
    seen = []
    (gc.enable if enabled else gc.disable)()
    try:
        GR.Graph(lambda: seen.append(gc.isenabled()), stream=None)
        assert seen == [False] and gc.isenabled() == enabled
    finally:
        gc.enable()
