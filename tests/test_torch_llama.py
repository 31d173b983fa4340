"""The port's LLaMA family (and the GPT class's LLaMA variant) against the
JAX package's, on the CPU in float32.

The JAX model's ``functional_state()`` params are carried across with
the shared `load_reference_state`; the same seeded numpy token ids go
through both.  `llama_tiny` has GQA 4 query heads over 2 kv heads.
Checked: `rms_norm` / `swiglu`; logits (tied and untied head) at atol
1e-4; cached prefill and decode logits (left-padded rows); greedy
`generate()` streams identical on an equal-length and a left-padded
GQA batch; the engine's streams identical to `generate()`'s and to the
JAX engine's (ragged prompts, page crossings, prefix hits; in
``tests/test_torch_llama_engine.py``, a file of its own so that the
suite spreads over its workers); the loss and
every gradient against ``jax.grad`` at 1e-4 relative; a 5-step f32 AdamW
trajectory against the JAX train step within 1e-4.  On the CPU the
kernel wrappers run their plain versions, so nothing here launches a
kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.core import flags as jflags
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import fleet, topology
from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.models.generation import init_kv_caches as j_init_caches
from paddle_tpu_torch import models as TM
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.optimizer import AdamW

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

TINY = dict(vocab_size=128, max_seq_len=64)


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _pair(tie=False, seed=0, **kw):
    P.seed(seed)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(**TINY, tie_embeddings=tie,
                                           **kw))
    jm.eval()
    tm = TL.LlamaForCausalLM(TL.llama_tiny(**TINY, tie_embeddings=tie,
                                           **kw), device="cpu")
    params, _ = jm.functional_state()
    TM.load_reference_state(tm, {n: np.asarray(x)
                                 for n, x in params.items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(0).randint(0, 128, (3, 11)).astype(
        np.int32)


def test_load_reference_state_is_shared():
    assert TM.load_reference_state is TG.load_reference_state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_swiglu_match_jax(dtype):
    """f32 to 1e-6.  bf16 to two bf16 ulps (2^-6 relative): both round
    the normalised value to bf16 before the weight multiply, but XLA
    fuses swiglu's chain in f32 and rounds once where PyTorch rounds
    after each op."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 16).astype(np.float32) * 3
    w = rs.randn(16).astype(np.float32)
    atol, rtol = (1e-6, 1e-6) if dtype == "float32" else (2 ** -7, 2 ** -6)
    jx, jw = (P.to_tensor(a).astype(dtype) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    for got, want in (
            (TF.rms_norm(tx, tw, epsilon=1e-5),
             P.nn.functional.rms_norm(jx, jw, epsilon=1e-5)),
            (TF.swiglu(tx), P.nn.functional.swiglu(jx)),
            (TF.swiglu(tx, tw), P.nn.functional.swiglu(jx, jw))):
        assert got.dtype == getattr(torch, dtype)
        want = np.asarray(want._value.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("tie", [False, True])
def test_forward_logits_match(tie, ids):
    jm, tm = _pair(tie=tie)
    assert (tm.lm_head is None) == tie
    jl = np.asarray(jm(P.to_tensor(ids, "int32"))._value)
    with torch.inference_mode():
        tl = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("left_pad", [False, True])
def test_static_cache_prefill_and_decode_logits_match(models, ids,
                                                      left_pad):
    """The rope positions of the cached paths: a cold (left-padded)
    prefill at cache_pos 0 with attn_start, then a decode step at
    cache_pos S0; the caches hold the 2 kv heads only."""
    jm, tm = models
    b, s0 = ids.shape
    start = np.asarray([0, 4, 2], np.int32) if left_pad else None
    nxt = np.asarray([[5], [17], [99]], np.int32)
    jc = j_init_caches(2, b, 2, 32, s0 + 4)
    jst = None if start is None else Tensor(jnp.asarray(start))
    with jflags.no_grad_guard():
        jl0, jc = jm(Tensor(jnp.asarray(ids)),
                     kv_caches=[(Tensor(k), Tensor(v)) for k, v in jc],
                     cache_pos=Tensor(jnp.asarray(0, jnp.int32)),
                     attn_start=jst)
        jl1, _ = jm(Tensor(jnp.asarray(nxt)), kv_caches=jc,
                    cache_pos=Tensor(jnp.asarray(s0, jnp.int32)),
                    attn_start=jst)
    tst = None if start is None else torch.from_numpy(start)
    with torch.inference_mode():
        tc = tm.init_kv_caches(b, s0 + 4)
        assert tc[0][0].shape == (b, 2, 128, 32)
        tl0, tc = tm(torch.from_numpy(ids), kv_caches=tc, cache_pos=0,
                     attn_start=tst)
        tl1, _ = tm(torch.from_numpy(nxt), kv_caches=tc, cache_pos=s0,
                    attn_start=tst)
    rows = slice(None) if start is None else start[:, None] <= np.arange(
        s0)[None, :]
    # left-pad rows' logits are garbage by design; compare real rows
    np.testing.assert_allclose(tl0.numpy()[rows],
                               np.asarray(jl0._value)[rows], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1._value),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["plain", "left_pad"])
def test_generate_streams_identical(models, ids, mode):
    jm, tm = models
    kw = {}
    if mode == "left_pad":
        mask = np.ones(ids.shape, np.int32)
        mask[0, :3] = 0
        mask[2, :6] = 0
        kw["attention_mask"] = mask
    jkw = dict(kw)
    if "attention_mask" in jkw:
        jkw["attention_mask"] = P.to_tensor(jkw["attention_mask"], "int32")
    jg = np.asarray(jm.generate(P.to_tensor(ids, "int32"),
                                max_new_tokens=10, **jkw)._value)
    tg = tm.generate(ids, max_new_tokens=10, **kw).numpy()
    np.testing.assert_array_equal(tg, jg)


def test_left_padded_gqa_row_equals_its_solo_stream(models):
    """As tests/test_models.py:371: a left-padded row of a ragged GQA
    batch continues exactly as the same prompt alone."""
    _, tm = models
    rs = np.random.RandomState(3)
    row = rs.randint(1, 128, (4,)).astype(np.int32)
    ref = tm.generate(row[None], max_new_tokens=6).numpy()[0, 4:]
    ids = np.zeros((2, 7), np.int32)
    mask = np.zeros((2, 7), np.int32)
    ids[0, 3:] = row
    mask[0, 3:] = 1
    ids[1] = rs.randint(1, 128, (7,))
    mask[1] = 1
    out = tm.generate(ids, max_new_tokens=6, attention_mask=mask).numpy()
    np.testing.assert_array_equal(out[0, 7:], ref)


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    ps = [rs.randint(0, 128, (n,)).astype(np.int32)
          for n in (3, 9, 17, 5, 12)]
    # two prompts sharing a 16-token prefix: the later one hits the
    # prefix cache (warm tail prefill, rope from position plen)
    shared = rs.randint(0, 128, (16,)).astype(np.int32)
    ps += [np.concatenate([shared, rs.randint(0, 128, (n,)).astype(
        np.int32)]) for n in (3, 7)]
    return ps


def test_rope_phases_once_per_forward(models, ids, prompts, monkeypatch):
    """A model forward computes its rotary phases once and hands them to
    every layer: `_rope_phases` runs once per forward of llama_tiny (2
    layers) and of the GPT class's rope variant, plain, cached prefill
    and decode, and every engine forward; the logits and the engine's
    tokens still equal the JAX model's."""
    from paddle_tpu_torch.nn.functional import attention as A

    calls = []
    orig = A._rope_phases

    def counted(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(A, "_rope_phases", counted)
    jm, tm = models
    jl = np.asarray(jm(P.to_tensor(ids, "int32"))._value)
    with torch.inference_mode():
        tl = tm(torch.from_numpy(ids)).numpy()
        assert len(calls) == 1
        b, s0 = ids.shape
        tc = tm.init_kv_caches(b, s0 + 4)
        _, tc = tm(torch.from_numpy(ids), kv_caches=tc, cache_pos=0)
        tm(torch.from_numpy(ids[:, :1]), kv_caches=tc, cache_pos=s0)
        assert len(calls) == 3
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    cfg = dict(page_size=4, max_slots=2, max_seq_len=64)
    jouts = JEngine(jm, JEngineConfig(**cfg)).generate(prompts[:3],
                                                       max_new_tokens=6)
    forwards = []
    hook = tm.register_forward_hook(lambda *a: forwards.append(1))
    try:
        del calls[:]
        outs = InferenceEngine(tm, EngineConfig(**cfg)).generate(
            prompts[:3], max_new_tokens=6)
    finally:
        hook.remove()
    assert len(calls) == len(forwards) > 0
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o, j)
    gpt = TG.GPTForCausalLM(TG.GPTConfig(**GPT_LLAMA), device="cpu")
    del calls[:]
    with torch.inference_mode():
        gpt(torch.from_numpy(ids % 96))
    assert len(calls) == 1


def _jax_loss_and_grads(jm, ids, labels):
    jm.train()
    jcrit = JL.LlamaPretrainingCriterion()
    params, buffers = jm.functional_state()

    def loss_of(p):
        with jflags.trace_guard():
            with jm.bind_state(p, buffers):
                loss = jcrit(jm(Tensor(jnp.asarray(ids))),
                             Tensor(jnp.asarray(labels)))
        return loss._value

    return jax.value_and_grad(loss_of)(params)


@pytest.mark.parametrize("tie", [False, True])
def test_llama_tiny_loss_and_grads_match_jax(tie):
    jm, tm = _pair(tie=tie, seed=2)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 128, (2, 24)).astype(np.int32)
    labels = rs.randint(0, 128, (2, 24)).astype(np.int32)
    labels[0, :3] = -100
    jl, jg = _jax_loss_and_grads(jm, ids, labels)
    tm.train()
    tl = TL.LlamaPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                        torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    names = dict(tm.named_parameters())
    assert set(names) == set(jg)
    for n, p in names.items():
        ref = np.asarray(jg[n])
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (n, err)


def test_train_step_loss_trajectory_matches_jax():
    """5 AdamW steps (lr 1e-4) on one fixed batch, f32, against the JAX
    `build_train_step` on the same weights."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 128, (2, 32)).astype(np.int32)
    labels = rs.randint(0, 128, (2, 32)).astype(np.int32)
    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        jm, tm = _pair(seed=4)
        model = fleet.distributed_model(jm)
        opt = fleet.distributed_optimizer(
            P.optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=1e-4))
        jstep = model.build_train_step(opt, JL.LlamaPretrainingCriterion(),
                                       amp_dtype=None)
        jids, jlab = P.to_tensor(ids, "int32"), P.to_tensor(labels, "int32")
        jl = [float(np.asarray(jstep(jids, jlab)._value)) for _ in range(5)]
    finally:
        topology.reset_topology()
    step = build_train_step(tm, AdamW(learning_rate=1e-4),
                            TL.LlamaPretrainingCriterion())
    tl = step.run_steps(ids, labels, repeat=5)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]


def test_unported_llama_options_raise():
    # dropout and recompute are ported; the parallel flags raise
    for field, value in (("sequence_parallel", True),
                         ("context_parallel", True)):
        with pytest.raises(NotImplementedError, match=field):
            TL.llama_tiny(**{field: value})
    with pytest.raises(ValueError, match="recompute policy"):
        TL.llama_tiny(recompute=True, recompute_policy="full_dots")
    cfg = TL.llama_tiny(dropout=0.1, recompute=True,
                        recompute_policy="dots")
    assert (cfg.dropout, cfg.recompute, cfg.recompute_policy) == \
        (0.1, True, "dots")
    cfg = TL.llama_tiny(dropout=0.0, recompute=False)
    assert (cfg.num_kv_heads, cfg.rope_theta, cfg.rms_eps) == (2, 1e4, 1e-6)
    assert TL.llama_7b().num_kv_heads == 32
    assert TL.llama2_70b_shapes().num_kv_heads == 8


# ------------------------------------------- the GPT class's LLaMA variant
GPT_LLAMA = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=64, use_rope=True, use_rmsnorm=True,
                 use_swiglu=True)


@pytest.mark.parametrize("tie", [False, True])
def test_gpt_llama_variant_logits_and_streams_match(tie, ids):
    cfg = dict(GPT_LLAMA, tie_embeddings=tie)
    P.seed(5)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**cfg))
    jm.eval()
    tm = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu")
    params, _ = jm.functional_state()
    TM.load_reference_state(tm, {n: np.asarray(x)
                                 for n, x in params.items()})
    assert tm.cfg.ffn_hidden == jm.cfg.ffn_hidden == 128   # SwiGLU rounding
    assert not hasattr(tm.gpt, "wpe")
    x = ids % 96
    jl = np.asarray(jm(P.to_tensor(x, "int32"))._value)
    with torch.inference_mode():
        tl = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    mask = np.ones(x.shape, np.int32)
    mask[1, :5] = 0
    jg = np.asarray(jm.generate(P.to_tensor(x, "int32"), max_new_tokens=6,
                                attention_mask=P.to_tensor(mask, "int32"))
                    ._value)
    tg = tm.generate(x, max_new_tokens=6, attention_mask=mask).numpy()
    np.testing.assert_array_equal(tg, jg)


def test_gpt_llama_7b_preset_and_fused_head_needs_tied_embeddings():
    cfg = TG.llama_7b()
    assert (cfg.use_rope, cfg.use_rmsnorm, cfg.use_swiglu,
            cfg.tie_embeddings, cfg.ffn_hidden) == (True, True, True, False,
                                                    11008)
    assert TM.gpt_llama_7b is TG.llama_7b
    model = TG.GPTForCausalLM(TG.GPTConfig(**GPT_LLAMA, fused_head_ce=True,
                                           tie_embeddings=False),
                              device="cpu")
    with pytest.raises(ValueError, match="tied embeddings"):
        TG.GPTPretrainingCriterion(model=model)
