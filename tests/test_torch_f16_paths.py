"""The port's float16 paths against the JAX package's, on the CPU.

Every kernel of these paths takes float16 on the card now (its own f16
instantiation, ``tests/test_torch_f16_kernels.py`` and
``chip_smoke.py``'s float16 phases); here the same weights, moved from
the JAX model's ``functional_state()`` by `load_reference_state`, and
the same seeded numpy inputs go through both packages in float16 at a
small size, the port's kernels running their plain versions:

  * a tiny LLaMA (`llama_tiny`, GQA 4 / 2) cast to float16 in both
    packages (the JAX model by ``Layer.to(dtype="float16")``, the port's
    built with ``dtype=torch.float16``): logits, greedy `generate()` and
    the engine on both KV tiers (exact and int8) against the JAX
    `generate()` and engine;
  * three ``amp_dtype="float16"`` train steps of a small Swin and of a
    tiny GPT under ``FLAGS_flash_layout=kv`` against the JAX
    `build_train_step(amp_dtype="float16")`;
  * the eval forward of a small ResNet and a MobileNetV2 x0.25 in
    float16 against the JAX model cast to float16;
  * three O1 float16 steps of the tiny LLaMA behind a `GradScaler`
    (AdamW, ``auto_cast(dtype="float16")``) against JAX's `amp` and
    `GradScaler`.

Tolerances: logits within 1e-2 of the largest (the two frameworks round
the f16 matmuls and norms at other places: 1.1e-3 measured); tokens
equal, or the first different token at a near-tie, where the top two
logits of the port's f16 forward over the reference stream's prefix differ by
no more than that tolerance (each accepted near-tie is reported as a
warning, in pytest's warnings summary; measured: one int8-KV stream at
a margin of 0.0098 against `generate()`, 5 f16 ulps at a largest
|logit| of 3.1); losses within 1e-2 relative.
Nothing here launches a kernel.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import amp as jamp
from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu.vision import models as JV
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.optimizer import optimizer as TO
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.vision import models as TV
from test_torch_train import TINY as GPT_TINY
from test_torch_train import _jax_losses
from test_torch_vision import _seed_bn_stats
from test_torch_vision_train import _jax_train

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

LOGIT_REL = 1e-2    # of the largest logit; also the near-tie margin
LOSS_REL = 1e-2
LLAMA = dict(vocab_size=128, max_seq_len=64)


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _llama_pair(seed=0):
    """(JAX model, port model), both float16, on the JAX model's
    weights (drawn in f32, each rounded once to f16 on both sides)."""
    P.seed(seed)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(**LLAMA))
    jm.eval()
    params = {n: np.asarray(x) for n, x in jm.functional_state()[0].items()}
    jm.to(dtype="float16")
    tm = TL.LlamaForCausalLM(TL.llama_tiny(**LLAMA), device="cpu",
                             dtype=torch.float16)
    load_reference_state(tm, params)
    return jm, tm


@pytest.fixture(scope="module")
def llama16():
    return _llama_pair()


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    ps = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (3, 9, 17, 5)]
    # a shared 16-token prefix: the later prompt takes the warm prefill
    ps.append(np.concatenate([ps[2][:16], [7, 8, 9]]).astype(np.int32))
    return ps


def _near_ties(tm, refs, outs, what):
    """Each stream of `outs` equals its `refs` stream, or first differs
    at a near-tie: the top two logits of the port's f16 forward over the
    reference prefix within LOGIT_REL of their largest |logit|.  Each
    accepted near-tie is reported as a warning."""
    for ref, out in zip(refs, outs):
        diff = np.flatnonzero(np.asarray(ref) != np.asarray(out))
        if not diff.size:
            continue
        at = int(diff[0])
        with torch.inference_mode():
            logits = tm(torch.from_numpy(np.asarray(ref)[None, :at]))[0, -1]
        logits = logits.float()
        top = torch.topk(logits, 2).values
        margin = (top[0] - top[1]).item()
        assert margin <= LOGIT_REL * logits.abs().max().item(), (
            f"{what}: diverged at token {at} with a top-2 margin {margin}")
        warnings.warn(f"{what}: near-tie at token {at}, top-2 margin "
                      f"{margin:.4g} of max |logit| "
                      f"{logits.abs().max().item():.4g}")


def test_llama_f16_logits_and_generate_match_jax(llama16):
    jm, tm = llama16
    assert all(p.dtype == torch.float16 for p in tm.parameters())
    ids = np.random.RandomState(1).randint(0, 128, (3, 11)).astype(np.int32)
    jl = np.asarray(jm(P.to_tensor(ids, "int32"))._value)
    assert jl.dtype == np.float16
    with torch.inference_mode():
        tl = tm(torch.from_numpy(ids))
    assert tl.dtype == torch.float16
    jl = jl.astype(np.float32)
    err = np.abs(tl.float().numpy() - jl).max()
    assert err <= LOGIT_REL * np.abs(jl).max(), err
    mask = np.ones(ids.shape, np.int32)
    mask[0, :3] = 0                         # a left-padded row
    for kw in ({}, {"attention_mask": mask}):
        jkw = {k: P.to_tensor(v, "int32") for k, v in kw.items()}
        jg = np.asarray(jm.generate(P.to_tensor(ids, "int32"),
                                    max_new_tokens=8, **jkw)._value)
        tg = tm.generate(ids, max_new_tokens=8, **kw).numpy()
        _near_ties(tm, jg, tg, f"generate {sorted(kw)}")


@pytest.mark.parametrize("kv", [None, "int8"])
def test_llama_f16_engine_matches_jax_engine_and_generate(llama16, prompts,
                                                          kv):
    """The engine in float16 on the exact tier (f16 page pools) and the
    int8 tier (int8 codes, f32 scales, f16 queries): streams against the
    JAX engine's, and against the port's sequential greedy `generate()`
    (the JAX package's own contract), both by the near-tie rule."""
    jm, tm = llama16
    cfg = dict(page_size=4, max_slots=2, max_seq_len=64)
    if kv:
        cfg["kv_precision"] = kv
    jouts = JEngine(jm, JEngineConfig(**cfg)).generate(prompts,
                                                       max_new_tokens=8)
    eng = InferenceEngine(tm, EngineConfig(**cfg))
    assert eng._k_pools[0].dtype == (torch.int8 if kv else torch.float16)
    outs = eng.generate(prompts, max_new_tokens=8)
    assert eng.prefix_cache_stats()["hits"] >= 1
    _near_ties(tm, jouts, outs, f"engine kv {kv} vs the JAX engine")
    refs = [tm.generate(p[None], max_new_tokens=8).numpy()[0]
            for p in prompts]
    _near_ties(tm, refs, outs, f"engine kv {kv} vs generate()")


def test_gpt_kv_tier_f16_train_steps_match_jax(monkeypatch):
    """Three ``amp_dtype="float16"`` AdamW steps of a tiny GPT under
    ``FLAGS_flash_layout=kv`` in both packages (the port's CPU path runs
    the plain attention under every flag; on the card the flag sends it
    through the relayouts and the head-major f16 flash kernels):
    losses within 1e-2 relative."""
    monkeypatch.setenv("FLAGS_flash_layout", "kv")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, GPT_TINY["vocab_size"], (2, 128)).astype(np.int32)
    labels = rs.randint(0, GPT_TINY["vocab_size"], (2, 128)).astype(
        np.int32)
    jl, tm = _jax_losses("float16", ids, labels, 3)
    step = build_train_step(tm, AdamW(parameters=tm.parameters(),
                                      learning_rate=1e-4),
                            TG.GPTPretrainingCriterion(model=tm),
                            amp_dtype="float16")
    tl = step.run_steps(ids, labels, repeat=3)
    assert tl.dtype == torch.float32 and bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), jl, rtol=LOSS_REL, atol=0)


def test_swin_f16_train_steps_match_jax():
    """Three ``amp_dtype="float16"`` Momentum steps of a 2-stage Swin
    (56x56, 7x7 windows, shifted blocks with the mask) against the JAX
    step: losses within 1e-2 relative."""
    rs = np.random.RandomState(0)
    imgs = rs.randn(2, 3, 56, 56).astype(np.float32)
    labels = rs.randint(0, 10, (2,)).astype(np.int32)
    jl, _, tm = _jax_train("swin_2stage", "float16", imgs, labels, 3)
    step = build_train_step(tm, Momentum(learning_rate=1e-3, momentum=0.9),
                            tnn.CrossEntropyLoss(), amp_dtype="float16")
    tl = step.run_steps(imgs, labels, repeat=3)
    assert tl.dtype == torch.float32 and bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), jl, rtol=LOSS_REL, atol=0)


@pytest.mark.parametrize("ctor,kw", [
    ("resnet18", dict(num_classes=10)),
    ("MobileNetV2", dict(scale=0.25, num_classes=10)),
])
def test_vision_f16_eval_forward_matches_jax(ctor, kw):
    """The eval forward (folded batch norm: `conv_bn_act` on every conv,
    depthwise included) in float16, on the JAX model's weights and
    seeded statistics, against the JAX model cast to float16: logits
    within 1e-2 of the largest."""
    P.seed(0)
    jm = getattr(JV, ctor)(**kw)
    jm.eval()
    _seed_bn_stats(jm, 1)
    params, buffers = jm.functional_state()
    tm = getattr(TV, ctor)(**kw, device="cpu")
    load_reference_state(tm, params, buffers)
    tm.to(torch.float16)
    jm.to(dtype="float16")
    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    want = np.asarray(jm(P.to_tensor(x).astype("float16")).numpy())
    assert want.dtype == np.float16
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).to(torch.float16))
    assert got.dtype == torch.float16 and got.shape == (2, 10)
    want = want.astype(np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= LOGIT_REL * np.abs(want).max(), err


def test_llama_o1_f16_scaler_steps_match_jax(monkeypatch):
    """Three O1 float16 steps of the tiny LLaMA (f32 parameters,
    ``auto_cast(dtype="float16")``, AdamW lr 1e-3) behind a
    `GradScaler(init_loss_scaling=2**10)` in both packages: the losses
    within 1e-2 relative, no step skipped, the same scale.  Every rope
    call, forward and adjoint, gets its phases in q's dtype (f16: the
    forward's phases follow the f32 hidden state and are cast as JAX
    casts them), which the card's kernel requires."""
    from paddle_tpu_torch.ops.kernels import rope as RP

    seen, plain = [], RP.rope

    def rope(x, cos, sin, *a, **kw):
        seen.append((x.dtype, cos.dtype, sin.dtype))
        return plain(x, cos, sin, *a, **kw)

    monkeypatch.setattr(RP, "rope", rope)
    P.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(**LLAMA))
    tm = TL.LlamaForCausalLM(TL.llama_tiny(**LLAMA), device="cpu")
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    jm.train()
    tm.train()
    jopt = P.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    topt = TO.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    js = jamp.GradScaler(init_loss_scaling=2.0 ** 10)
    ts = tamp.GradScaler(init_loss_scaling=2.0 ** 10)
    jcrit, tcrit = JL.LlamaPretrainingCriterion(), \
        TL.LlamaPretrainingCriterion()
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 128, (2, 16)).astype(np.int32)
    labels = rs.randint(0, 128, (2, 16)).astype(np.int32)
    jl, tl = [], []
    for _ in range(3):
        with jamp.auto_cast(dtype="float16"):
            jloss = jcrit(jm(P.to_tensor(ids, "int32")),
                          P.to_tensor(labels, "int32"))
        js.scale(jloss).backward()
        js.step(jopt)
        js.update()
        jopt.clear_grad()
        jl.append(float(np.asarray(jloss.astype("float32").numpy())))
        with tamp.auto_cast(dtype="float16"):
            tloss = tcrit(tm(torch.from_numpy(ids)),
                          torch.from_numpy(labels))
        ts.scale(tloss).backward()
        ts.step(topt)
        assert not ts._found_inf
        ts.update()
        topt.clear_grad()
        tl.append(float(tloss.detach().float()))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert seen and all(d == (torch.float16,) * 3 for d in seen), seen
    assert float(ts.get_loss_scaling()) == float(
        js.get_loss_scaling().numpy())
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL, atol=0)
