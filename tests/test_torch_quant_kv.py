"""The port's int8 KV serving tier on the CPU, against the JAX package.

  * the int8 codec (`paddle_tpu_torch.ops.quant`) bit for bit against
    `paddle_tpu.ops.quant`: codes and scales, with all-zero vectors,
    exact .5 ties and +-127 saturation;
  * the int8 paged-attention plain version against JAX `paged_attention`
    in interpret mode and `paged_attention_reference` (page crossings, an
    exact page end, pos 0, the full table, GQA 8/2), within 2e-5;
  * the decode write of a 5-tuple cache (`_paged_cache_attention`) bit
    for bit against the JAX function's, and the engine's pack bit for bit
    against token-by-token decode writes;
  * the engine on `gpt_tiny`-sized GPT and LLaMA models in f32 with
    ``kv_precision="int8"``: streams equal to the JAX int8 engine's on
    the same weights, bit-stable run to run, eviction and recompute, the
    warm prefill reading the exact sidecar, `defrag` mid-flight, the
    ``pool_hbm_mb`` capacity, stats and gauges.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu.models import generation as JGEN
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models import llama as JL
from paddle_tpu.ops import quant as JQ
from paddle_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from paddle_tpu_torch import models as TM
from paddle_tpu_torch.models import generation as GEN
from paddle_tpu_torch.models.gpt import (
    GPTConfig, GPTForCausalLM, load_reference_state,
)
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.ops import quant as Q
from paddle_tpu_torch.ops.kernels import paged_attention as PA

# the module (the package re-exports a function of the same name)
JPA = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

GPT_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=64)
LLAMA_CFG = dict(vocab_size=128, max_seq_len=64)    # llama_tiny: GQA 4/2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------------ codec

def _codec_inputs():
    rs = np.random.RandomState(0)
    x = rs.randn(6, 5, 16).astype(np.float32) * 3.0
    x[0, 0] = 0.0                                  # an all-zero vector
    # exact .5 ties: absmax 127 makes the scale 1, so x / scale keeps the
    # tie and round-half-to-even decides it
    x[1, 0] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                        -3.5, 4.5, 10.5, -10.5, 0.0, 1.0, -126.5, 126.5],
                       np.float32)
    # saturation: the largest |x| encodes to exactly +-127
    x[2, 1, 3] = 1e4
    x[2, 2, 7] = -1e4
    x[3, 3] = 1e-30                                # tiny but nonzero
    return x


@pytest.mark.parametrize("fn", ["quantize_vectors", "quantize_channels",
                                "quantize_chunked"])
def test_codec_bit_equal_to_jax(fn):
    x = _codec_inputs()
    got = getattr(Q, fn)(torch.from_numpy(x))
    want = getattr(JQ, fn)(jnp.asarray(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, int):
            assert g == w
            continue
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def test_codec_contract_ties_zeros_saturation_roundtrip():
    x = _codec_inputs()
    codes, scales = Q.quantize_vectors(torch.from_numpy(x))
    codes, scales = codes.numpy(), scales.numpy()
    assert scales[0, 0] == 1.0 and not codes[0, 0].any()
    assert codes[1, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, -4, 4, 10,
                                    -10, 0, 1, -126, 126]
    assert codes[2, 1, 3] == 127 and codes[2, 2, 7] == -127
    assert np.abs(codes).max() <= 127
    # round trip within absmax / 127 of each vector, both inverses
    back = Q.dequantize_vectors(torch.from_numpy(codes),
                                torch.from_numpy(scales)).numpy()
    bound = np.abs(x).max(-1, keepdims=True) / 127.0
    assert (np.abs(back - x) <= bound + 1e-6 * np.abs(x)).all()
    cq, cs, pad = Q.quantize_chunked(torch.from_numpy(x), chunk=64)
    np.testing.assert_array_equal(
        Q.dequantize_chunked(cq, cs, x.shape, pad).numpy(),
        np.asarray(JQ.dequantize_chunked(*JQ.quantize_chunked(
            jnp.asarray(x), chunk=64)[:2], x.shape, pad)))
    wq, ws = Q.quantize_channels(torch.from_numpy(x[0]), axis=0)
    np.testing.assert_array_equal(
        Q.dequantize_channels(wq, ws, torch.bfloat16).float().numpy(),
        np.asarray(JQ.dequantize_channels(
            *JQ.quantize_channels(jnp.asarray(x[0]), axis=0),
            jnp.bfloat16).astype(jnp.float32)))
    # scale = absmax / 127 as a true f32 division, 1 for a silent block
    am = torch.tensor([0.0, 1.0, 3.0, 127.0, 1e-30])
    np.testing.assert_array_equal(
        Q.scales_from_absmax(am).numpy(),
        np.asarray(JQ.scales_from_absmax(jnp.asarray(am.numpy()))))


# ------------------------------------------------------- paged attention

def _pools(rs, npool, hkv, ps, d):
    kf = rs.randn(npool, hkv, ps, d).astype(np.float32)
    vf = rs.randn(npool, hkv, ps, d).astype(np.float32)
    return kf, vf


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_int8_paged_plain_matches_jax_kernel_and_reference(hq, hkv):
    """The JAX kernel's int8 branch (interpret mode) and its reference at
    tests/test_quantized_decode.py's shapes: a page crossing (25), an
    exact page end (15), one token (0), the full table (31)."""
    rs = np.random.RandomState(1)
    b, d, ps, npool = 4, 16, 8, 12
    q = rs.randn(b, hq, d).astype(np.float32)
    kf, vf = _pools(rs, npool, hkv, ps, d)
    kq, ks = JQ.quantize_vectors(jnp.asarray(kf))
    vq, vs = JQ.quantize_vectors(jnp.asarray(vf))
    pt = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                   [8, 9, 10, 11]], np.int32)
    pos = np.array([25, 15, 0, 31], np.int32)
    jargs = (jnp.asarray(q), kq, vq, jnp.asarray(pt), jnp.asarray(pos))
    want_k = JPA.paged_attention(*jargs, interpret=True, k_scales=ks,
                                 v_scales=vs)
    want_r = JPA.paged_attention_reference(*jargs, k_scales=ks, v_scales=vs)
    t = torch.from_numpy
    got = PA.paged_attention(t(q), t(np.asarray(kq)), t(np.asarray(vq)),
                             t(pt), t(pos), k_scales=t(np.asarray(ks)),
                             v_scales=t(np.asarray(vs)))
    assert got.dtype == torch.float32 and got.shape == (b, hq, d)
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    # the exact tier's plain version is unchanged by the int8 branch
    exact = PA.paged_attention(t(q), t(kf), t(vf), t(pt), t(pos))
    np.testing.assert_allclose(
        exact.numpy(), np.asarray(JPA.paged_attention_reference(
            jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
            jnp.asarray(pt), jnp.asarray(pos))), rtol=2e-5, atol=2e-5)


def test_int8_paged_scales_come_in_pairs():
    z = torch.zeros(2, 1, 4, 16)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        PA.paged_attention(torch.zeros(1, 1, 16), z.to(torch.int8),
                           z.to(torch.int8), idx.reshape(1, 1), idx,
                           k_scales=z[..., 0])


def test_paged_cache_write_bit_equal_to_jax_write_q():
    """One decode step through a 5-tuple cache: int8 codes and scales land
    in (page_table[b, pos // ps], pos % ps), bit for bit as the JAX
    `write_q`; the attention output agrees within 2e-5.  Row 3 is a free
    slot (pos 0, scratch table)."""
    rs = np.random.RandomState(4)
    b, hq, hkv, d, ps, npool = 4, 4, 2, 16, 4, 9
    q = rs.randn(b, 1, hq, d).astype(np.float32)
    k = rs.randn(b, 1, hkv, d).astype(np.float32)
    v = rs.randn(b, 1, hkv, d).astype(np.float32)
    kq, ks = JQ.quantize_vectors(jnp.asarray(rs.randn(npool, hkv, ps, d),
                                             jnp.float32))
    vq, vs = JQ.quantize_vectors(jnp.asarray(rs.randn(npool, hkv, ps, d),
                                             jnp.float32))
    pt = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [0, 0, 0]], np.int32)
    pos = np.array([9, 4, 0, 0], np.int32)      # mid-page, page start
    jcache = tuple(JTensor(x) for x in (kq, vq, jnp.asarray(pt), ks, vs))
    jout, jnew = JGEN._paged_cache_attention(
        JTensor(jnp.asarray(q)), JTensor(jnp.asarray(k)),
        JTensor(jnp.asarray(v)), jcache, JTensor(jnp.asarray(pos)))
    t = torch.from_numpy
    cache = tuple(t(np.array(x)) for x in (kq, vq, pt, ks, vs))
    out, new = GEN._paged_cache_attention(t(q), t(k), t(v), cache, t(pos))
    assert len(new) == 5 and all(a is b for a, b in zip(new, cache))
    for got, want in zip(new, jnew):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout._value),
                               rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def gpt():
    P.seed(0)
    jm = JGPT(JGPTConfig(**GPT_CFG))
    jm.eval()
    params, _ = jm.functional_state()
    tm = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return jm, tm


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    ps = [rs.randint(0, 128, (n,)).astype(np.int32)
          for n in (3, 9, 17, 5, 12)]
    # two prompts sharing a 16-token prefix: warm prefills at page 4 / 8
    shared = rs.randint(0, 128, (16,)).astype(np.int32)
    ps += [np.concatenate([shared, rs.randint(0, 128, (n,)).astype(
        np.int32)]) for n in (3, 7)]
    return ps


def _drained(eng):
    st = eng.pool.stats()
    assert st["logical_pages"] == st["used"], st
    eng.clear_prefix_cache()
    assert eng.pool.used_pages == 0, eng.pool.stats()


INT8_CASES = {
    "chunked": dict(page_size=8, max_slots=3, decode_chunk=2),
    "evict": dict(page_size=4, max_slots=2, num_pages=10),
    "small_pages": dict(page_size=4, max_slots=2),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_engine_streams_equal_jax_int8_engine(gpt, prompts, case):
    """Token for token against the JAX int8 engine on the same weights;
    bit-stable run to run; the first token (off the exact dense prefill)
    equals greedy; the evict case preempts and recomputes mid-flight."""
    jm, tm = gpt
    cfg = dict(INT8_CASES[case], max_seq_len=64, kv_precision="int8")
    jouts = JEngine(jm, JEngineConfig(**cfg)).generate(prompts,
                                                       max_new_tokens=10)
    runs = []
    for _ in range(2):
        eng = InferenceEngine(tm, EngineConfig(**cfg))
        runs.append(eng.generate(prompts, max_new_tokens=10))
        assert eng.prefix_cache_stats()["hits"] >= 1   # warm prefill ran
        _drained(eng)
    for j, o1, o2 in zip(jouts, *runs):
        np.testing.assert_array_equal(o1, j)
        np.testing.assert_array_equal(o1, o2)
    for p, o in zip(prompts, runs[0]):
        ref = tm.generate(p[None], max_new_tokens=1).numpy()[0]
        np.testing.assert_array_equal(o[:p.size + 1], ref)


def test_int8_engine_llama_gqa_equals_jax(prompts):
    """GQA 4/2 through the int8 pools (per-kv-head scales)."""
    P.seed(3)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(**LLAMA_CFG))
    jm.eval()
    params, _ = jm.functional_state()
    tm = TL.LlamaForCausalLM(TL.llama_tiny(**LLAMA_CFG), device="cpu")
    TM.load_reference_state(tm, {k: np.asarray(v)
                                 for k, v in params.items()})
    cfg = dict(page_size=8, max_slots=2, max_seq_len=64,
               kv_precision="int8")
    jouts = JEngine(jm, JEngineConfig(**cfg)).generate(prompts[:4] +
                                                       prompts[5:],
                                                       max_new_tokens=8)
    eng = InferenceEngine(tm, EngineConfig(**cfg))
    assert eng._k_pools[0].shape[1] == 2 and eng._k_scales[0].shape[1] == 2
    outs = eng.generate(prompts[:4] + prompts[5:], max_new_tokens=8)
    for j, o in zip(jouts, outs):
        np.testing.assert_array_equal(o, j)
    _drained(eng)


def test_int8_engine_llama_one_kv_head_equals_jax(prompts):
    """One kv head (MQA 4/1): the exact page copies the commit takes out
    of the prefill are contiguous views of the dense buffers' layout, so
    a copy that aliased graph memory would go unnoticed; the warm
    prefills read the sidecar, and the streams equal the JAX int8
    engine's token for token."""
    P.seed(4)
    cfg = dict(LLAMA_CFG, num_kv_heads=1)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(**cfg))
    jm.eval()
    params, _ = jm.functional_state()
    tm = TL.LlamaForCausalLM(TL.llama_tiny(**cfg), device="cpu")
    TM.load_reference_state(tm, {k: np.asarray(v)
                                 for k, v in params.items()})
    ecfg = dict(page_size=4, max_slots=2, max_seq_len=64,
                kv_precision="int8")
    jouts = JEngine(jm, JEngineConfig(**ecfg)).generate(prompts,
                                                        max_new_tokens=8)
    eng = InferenceEngine(tm, EngineConfig(**ecfg))
    assert eng._k_pools[0].shape[1] == 1
    outs = eng.generate(prompts, max_new_tokens=8)
    assert eng.prefix_cache_stats()["hits"] >= 1
    for j, o in zip(jouts, outs):
        np.testing.assert_array_equal(o, j)
    _drained(eng)


def test_int8_pack_bit_equal_to_token_by_token_writes(gpt, prompts):
    """The pack quantizes each page chunk per vector: the pools after a
    cold prefill hold exactly what one decode write per prompt token
    (`_paged_cache_attention` on a 5-tuple) stores."""
    _, tm = gpt
    eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                           max_seq_len=64,
                                           kv_precision="int8",
                                           prefix_cache=0))
    prompt = prompts[2]                              # 17 tokens, 5 pages
    s0, ps = prompt.size, 4
    sb = eng._bucket(s0)
    start = sb - s0
    ids = np.zeros((1, sb), np.int32)
    ids[0, start:] = prompt
    with torch.inference_mode():
        _, kbufs, vbufs = eng._run_prefill(sb, ids, start)
        pages = np.array([3, 7, 1, 5, 2], np.int32)
        eng._run_pack(kbufs, vbufs, np.pad(pages, (0, -(-sb // ps) - 5)),
                      start)
        hkv, d = eng._hkv, eng._hd
        shape = eng._k_pools[0].shape
        pt = torch.from_numpy(pages[None])
        for li in range(eng._layers):
            kp, vp = (torch.zeros(shape, dtype=torch.int8) for _ in "kv")
            ks, vs = (torch.ones(shape[:3]) for _ in "kv")
            for tkn in range(s0):
                kt = kbufs[li][:, :, start + tkn][:, None]   # [1,1,hkv,d]
                vt = vbufs[li][:, :, start + tkn][:, None]
                GEN._paged_cache_attention(
                    torch.zeros(1, 1, hkv, d), kt, vt, (kp, vp, pt, ks, vs),
                    torch.tensor([tkn], dtype=torch.int32))
            live = torch.from_numpy(pages).long()
            for got, want in ((eng._k_pools[li], kp), (eng._v_pools[li], vp),
                              (eng._k_scales[li], ks),
                              (eng._v_scales[li], vs)):
                g, w = got[live], want[live]
                # the last page's slots past the prompt hold the pack's
                # copy of the buffer's tail; decode overwrites them
                g = g.reshape(5 * ps, -1)[:s0] if g.dim() == 3 \
                    else g.transpose(1, 2).reshape(5 * ps, hkv, d)[:s0]
                w = w.reshape(5 * ps, -1)[:s0] if w.dim() == 3 \
                    else w.transpose(1, 2).reshape(5 * ps, hkv, d)[:s0]
                assert torch.equal(g, w)


def test_int8_warm_prefill_reads_the_exact_sidecar(gpt, prompts):
    """A prefix-cache hit under the int8 tier attends the commit-time
    exact copy of each shared page: wiping the shared pages' int8 codes
    leaves the warm prefill's token unchanged (the decode steps after it
    do read the pools), and a node without its sidecar is a commit-path
    bug that raises."""
    _, tm = gpt
    cfg = EngineConfig(page_size=4, max_slots=1, max_seq_len=64,
                       kv_precision="int8")
    first, warm = prompts[5], prompts[6]
    eng = InferenceEngine(tm, cfg)
    eng.generate([first], max_new_tokens=4)
    want = eng.generate([warm], max_new_tokens=6)[0]
    assert eng.prefix_cache_stats()["hits"] == 1
    eng2 = InferenceEngine(tm, cfg)
    eng2.generate([first], max_new_tokens=4)
    nodes = list(eng2._prefix._children.values())
    assert nodes and all(n.exact is not None for n in nodes)
    ex = nodes[0].exact
    assert len(ex) == eng2._layers and ex[0][0].shape == (eng2._hkv, 4,
                                                          eng2._hd)
    with torch.inference_mode():
        for pool in eng2._k_pools + eng2._v_pools:
            pool[nodes[0].page] = 0             # the int8 copy is wiped
    got = eng2.generate([warm], max_new_tokens=6)[0]
    assert eng2.prefix_cache_stats()["hits"] == 1
    np.testing.assert_array_equal(got[:warm.size + 1], want[:warm.size + 1])
    eng3 = InferenceEngine(tm, cfg)
    eng3.generate([first], max_new_tokens=4)
    for node in eng3._prefix._children.values():
        node.exact = None
    with pytest.raises(RuntimeError, match="commit-path bug"):
        eng3.generate([warm], max_new_tokens=2)


def test_int8_defrag_mid_flight_moves_scales(gpt, prompts):
    _, tm = gpt
    cfg = EngineConfig(page_size=4, max_slots=3, max_seq_len=64,
                       kv_precision="int8", prefix_cache=0)
    want = InferenceEngine(tm, cfg).generate(prompts, max_new_tokens=10)
    eng = InferenceEngine(tm, cfg)
    handles = [eng.submit(p, max_new_tokens=10) for p in prompts]
    moved = 0
    while any(not h.done.is_set() for h in handles):
        eng.step()
        if eng.steps % 3 == 0:
            moved += eng.defrag()
    assert moved > 0
    for w, h in zip(want, handles):
        np.testing.assert_array_equal(h.result(), w)


def test_int8_pool_budget_stats_and_gauges(gpt):
    """A pool_hbm_mb budget admits more than 1.9x the pages under int8
    (1 byte per element + 4 per scale vs 4 per f32 element); stats and
    the pool-precision gauge name the tier."""
    _, tm = gpt
    was = tmetrics.enabled()
    tmetrics.enable()
    try:
        tmetrics.reset()
        exact = InferenceEngine(tm, EngineConfig(page_size=8, max_slots=2,
                                                 pool_hbm_mb=0.05))
        assert tmetrics.snapshot()["gauges"][
            "paged.pool_precision{precision=full}"] == 1
        tmetrics.reset()
        q8 = InferenceEngine(tm, EngineConfig(page_size=8, max_slots=2,
                                              pool_hbm_mb=0.05,
                                              kv_precision="int8"))
        g = tmetrics.snapshot()["gauges"]
        assert g["paged.pool_precision{precision=int8}"] == 1
    finally:
        if not was:
            tmetrics.disable()
    hkv, d, layers, ps = 4, 8, 2, 8
    assert exact.stats()["page_bytes"] == layers * 2 * hkv * ps * d * 4
    assert q8.stats()["page_bytes"] == layers * 2 * (hkv * ps * d
                                                     + hkv * ps * 4)
    assert q8.config.num_pages >= 1.9 * exact.config.num_pages
    st = q8.stats()
    assert st["kv_precision"] == "int8" and exact.stats()[
        "kv_precision"] == "full"
    assert q8._k_pools[0].dtype == torch.int8
    assert q8._k_scales[0].shape == (q8.config.num_pages, hkv, ps)
    assert bool((q8._k_scales[0] == 1).all())
