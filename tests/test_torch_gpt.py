"""The port's GPT against the JAX package's, on the CPU in float32.

The JAX model's ``functional_state()`` params are carried across with
`load_reference_state`; the same seeded numpy token ids go through
both.  Logits agree to atol 1e-4 (f32 matmul reduction order over a
2-layer, 32-wide model); greedy token streams are identical.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.core import flags as jflags
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.generation import init_kv_caches as j_init_caches
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.models.gpt import (
    GPTConfig, GPTForCausalLM, load_reference_state,
)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)


def _pair(seed=0):
    P.seed(seed)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    params, _ = jm.functional_state()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(0).randint(0, 128, (3, 11)).astype(
        np.int32)


def test_forward_logits_match(models, ids):
    jm, tm = models
    jl = np.asarray(jm(P.to_tensor(ids, "int32"))._value)
    with torch.inference_mode():
        tl = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("left_pad", [False, True])
def test_static_cache_prefill_and_decode_logits_match(models, ids,
                                                      left_pad):
    jm, tm = models
    b, s0 = ids.shape
    start = np.asarray([0, 4, 2], np.int32) if left_pad else None
    nxt = np.asarray([[5], [17], [99]], np.int32)
    jc = j_init_caches(2, b, 4, 8, s0 + 4)
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


@pytest.mark.parametrize("mode", ["plain", "left_pad", "eos", "eos_pad"])
def test_generate_streams_identical(models, ids, mode):
    jm, tm = models
    kw = {}
    if "pad" in mode:
        mask = np.ones(ids.shape, np.int32)
        mask[0, :3] = 0
        mask[2, :6] = 0
        kw["attention_mask"] = mask
    if "eos" in mode:
        # an eos the model emits early in row 0, so freezing and the
        # stop point both matter
        probe = np.asarray(tm.generate(ids, max_new_tokens=6, **kw))
        kw["eos_token_id"] = int(probe[0, ids.shape[1] + 1])
    jkw = dict(kw)
    if "attention_mask" in jkw:
        jkw["attention_mask"] = P.to_tensor(jkw["attention_mask"], "int32")
    jg = np.asarray(jm.generate(P.to_tensor(ids, "int32"),
                                max_new_tokens=12, **jkw)._value)
    tg = tm.generate(ids, max_new_tokens=12, **kw).numpy()
    assert tg.dtype == np.int32
    np.testing.assert_array_equal(tg, jg)


def test_load_reference_state_checks_names_and_shapes(models):
    jm, _ = models
    params = {k: np.asarray(v) for k, v in jm.functional_state()[0].items()}
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    missing = dict(params)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="gpt.ln_f.bias"):
        load_reference_state(tm, missing)
    with pytest.raises(KeyError, match="extra.weight"):
        load_reference_state(tm, dict(params, **{"extra.weight":
                                                  np.zeros(3)}))
    bad = dict(params)
    bad["gpt.wpe.weight"] = np.zeros((63, 32), np.float32)
    with pytest.raises(ValueError, match="gpt.wpe.weight"):
        load_reference_state(tm, bad)
    load_reference_state(tm, params)
    assert tm.gpt.h[0].attn.qkv_proj.weight.shape == (32, 96)  # [in, out]


def test_unported_options_raise():
    # the LLaMA variant's fields are ported; dropout, recompute and the
    # parallel flags raise when set
    for field in ("dropout", "attn_dropout", "recompute",
                  "sequence_parallel", "context_parallel"):
        with pytest.raises(NotImplementedError, match=field):
            GPTConfig(**{field: True}, **CFG)
    cfg = GPTConfig(use_rope=True, use_rmsnorm=True, use_swiglu=True,
                    tie_embeddings=False, dropout=0.0, **CFG)
    assert cfg.ffn_hidden == 128        # SwiGLU: 8/3 of 32, rounded to 128
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    # the message sends readers to the queue that ports them
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A5"):
        tm.generate(np.zeros((1, 3), np.int32), do_sample=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A5"):
        tm.generate(np.zeros((1, 3), np.int32), num_beams=2)


def test_bf16_forward_runs_close_to_f32(models, ids):
    """bf16 on the CPU path: finite logits near the f32 ones (bf16 keeps
    ~3 significant digits; logits here are O(10))."""
    _, tm = models
    tb = GPTForCausalLM(GPTConfig(**CFG), device="cpu",
                        dtype=torch.bfloat16)
    tb.load_state_dict({k: v.to(torch.bfloat16)
                        for k, v in tm.state_dict().items()})
    with torch.inference_mode():
        lf = tm(torch.from_numpy(ids))
        lb = tb(torch.from_numpy(ids)).float()
    assert torch.isfinite(lb).all()
    assert (lb - lf).abs().max() < 0.5
