"""The port's training path against the JAX package's, on the CPU.

The same seeded numpy inputs (and, for the models, the same weights,
moved from ``functional_state()`` by `load_reference_state`) go through
both packages in float32:

  (a) the flash backward's plain version against ``jax.grad`` through
      the Pallas cores in interpret mode (`_flash_core_flat`, the
      default tier, and the padded `_flash_core`), max abs diff 1e-4;
  (b) the biased backward against ``jax.grad`` through `_flash_core_b`,
      through the port's `FlashAttention`; the bias gets no gradient;
  (c) the chunked CE and the fused head + CE, loss and grads, 1e-5
      relative;
  (d) one Adam / AdamW update against `apply_gradients`, 1e-6;
  (e) every parameter's gradient of `gpt_tiny` with the fused head + CE
      against ``jax.grad`` of the JAX model's loss, 1e-4 relative;
  (f) 5-step loss trajectories of the train step against the JAX
      `build_train_step` at bench.py's CPU configuration: f32 within
      1e-4, bf16 AMP within 5e-3 (see the test for the measured gap).

On the CPU the kernel wrappers run their plain versions, so nothing here
launches a kernel.  The kernels are held against these plain versions
on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
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
from paddle_tpu.models import gpt as JG
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.optimizer.optimizer import Adam as JAdam
from paddle_tpu.optimizer.optimizer import AdamW as JAdamW
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels.flash_attention import (
    FlashAttention, flash_bwd, flash_fwd,
)
from paddle_tpu_torch.optimizer import Adam, AdamW

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _qkvg(rs, b, sq, sk, hq, hkv, d):
    return (rs.randn(b, sq, hq, d).astype(np.float32),
            rs.randn(b, sk, hkv, d).astype(np.float32),
            rs.randn(b, sk, hkv, d).astype(np.float32),
            rs.randn(b, sq, hq, d).astype(np.float32))


def _port_grads(q, k, v, g, bias=None, causal=False):
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_fwd(tq, tk, tv, bias=bias, causal=causal)
    return [x.numpy() for x in flash_bwd(tq, tk, tv, out, lse, tg,
                                         bias=bias, causal=causal)]


def _jax_grads(core, q, k, v, g):
    def loss(q_, k_, v_):
        return (core(q_, k_, v_) * g).sum()

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 16, 16, 4, 4, 16, True),    # MHA, self-attention
    (2, 16, 16, 4, 4, 16, False),
    (1, 16, 32, 4, 2, 16, True),    # GQA, Sk > Sq (bottom-right diagonal)
    (1, 16, 32, 4, 2, 16, False),
    # Sq > Sk, GQA rep 2, full attention only: causal, the first Sq - Sk
    # rows would see no key at all
    (2, 24, 8, 2, 1, 32, False),
])
def test_flash_bwd_plain_matches_flat_core_grad(b, sq, sk, hq, hkv, d,
                                                causal):
    rs = np.random.RandomState(sq * 7 + sk)
    q, k, v, g = _qkvg(rs, b, sq, sk, hq, hkv, d)
    want = _jax_grads(
        lambda q_, k_, v_: JFA._flash_core_flat(q_, k_, v_, causal, 8, 8),
        q, k, v, g)
    for got, ref in zip(_port_grads(q, k, v, g, causal=causal), want):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (1, 13, 21, 4, 2, 8),       # GQA, odd lengths, Sk > Sq
    (2, 9, 9, 6, 2, 32),        # GQA rep 3, odd self-attention
    (1, 1, 11, 2, 2, 16),       # one query row
])
def test_flash_bwd_plain_matches_padded_core_grad(b, sq, sk, hq, hkv, d,
                                                  causal):
    """Odd lengths run the JAX package's transpose core over arrays
    zero-padded to a multiple of 8 with real-length masking
    (`flash_attention_fwd` :1863-1904): its `_bwd_t` gradients."""
    rs = np.random.RandomState(sq * 5 + sk)
    q, k, v, g = _qkvg(rs, b, sq, sk, hq, hkv, d)

    def core(q_, k_, v_):
        def pad(x):
            return jnp.pad(x, ((0, 0), (0, (-x.shape[1]) % 8), (0, 0),
                               (0, 0)))
        return JFA._flash_core(pad(q_), pad(k_), pad(v_), causal, 8, 8,
                               sq, sk)[:, :sq]

    want = _jax_grads(core, q, k, v, g)
    for got, ref in zip(_port_grads(q, k, v, g, causal=causal), want):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["additive", "bool"])
@pytest.mark.parametrize("bias_shape", [
    (1, 1, 16, 24),     # broadcast over batch and head
    (2, 1, 16, 24),     # per batch row
    (2, 3, 16, 24),     # full
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bias_grad_matches_core_b(bias_shape, kind, causal):
    b, h, sq, sk, d = 2, 3, 16, 24, 16
    rs = np.random.RandomState(11)
    q, k, v, g = _qkvg(rs, b, sq, sk, h, h, d)
    if kind == "bool":
        mask = rs.rand(*bias_shape) > 0.3
        # keep the bottom-right diagonal so no row is fully masked
        mask |= np.eye(sq, sk, k=sk - sq, dtype=bool)
        jbias = np.where(mask, 0.0, JFA.NEG_INF).astype(np.float32)
        tbias = torch.from_numpy(mask)
    else:
        jbias = rs.randn(*bias_shape).astype(np.float32)
        tbias = torch.from_numpy(jbias).requires_grad_()

    def loss(q_, k_, v_, bias_):
        return (JFA._flash_core_b(q_, k_, v_, bias_, causal, 8, 8)
                * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, jbias)))
    assert not np.asarray(want[3]).any()      # JAX: zero bias cotangent
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FlashAttention.apply(tq, tk, tv, tbias, causal)
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=0)
    if kind == "additive":
        # the port gives a trainable bias its gradient (ROADMAP C1.2): the
        # JAX entry sends such a mask to its reference path, whose
        # gradient is the oracle
        def ref(bias_):
            return (JFA._ref_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                       bias_, causal) * g).sum()

        want_bias = jax.grad(ref)(jnp.asarray(jbias))
        assert np.abs(np.asarray(want_bias)).max() > 0
        np.testing.assert_allclose(tbias.grad.numpy(), np.asarray(want_bias),
                                   atol=1e-4, rtol=0)


def test_flash_bwd_pad_rows_finite_and_zero_without_cotangent():
    """Fully masked (left-pad) query rows: finite gradients, and zero
    contribution anywhere when their cotangent is zero (a loss that
    ignores pad positions gives them none)."""
    b, s, h, d = 2, 12, 2, 8
    rs = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(x) for x in _qkvg(rs, b, s, s, h, h, d))
    start = torch.tensor([5, 0])
    keys = torch.arange(s)
    bias = torch.where(keys[None] >= start[:, None], 0.0,
                       -1e30)[:, None, None]
    out, lse = flash_fwd(q, k, v, bias=bias, causal=True)
    grads = flash_bwd(q, k, v, out, lse, g, bias=bias, causal=True)
    assert all(torch.isfinite(x).all() for x in grads)
    g0 = g.clone()
    g0[0, :5] = 0
    dq, dk, dv = flash_bwd(q, k, v, out, lse, g0, bias=bias, causal=True)
    assert not dq[0, :5].any()
    # real rows never see the pad keys: those keys get no gradient
    assert not dk[0, :5].any() and not dv[0, :5].any()


# ------------------------------------------------------------ (c) the CE
@pytest.mark.parametrize("n_chunks", [16, 7])
@pytest.mark.parametrize("dtype", [np.float32])
def test_fused_linear_ce_matches_jax(n_chunks, dtype):
    rs = np.random.RandomState(n_chunks)
    n, hd, v = 37, 24, 100            # 100 % 16 != 0: ragged last chunks
    h = rs.randn(n, hd).astype(dtype)
    w = (rs.randn(v, hd) * 0.5).astype(dtype)
    labels = rs.randint(0, v, (n,)).astype(np.int32)
    labels[[3, 17, 30]] = -100

    def jloss(h_, w_):
        return JG._fused_linear_ce(h_, w_, jnp.asarray(labels), -100,
                                   n_chunks)[0]

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    total, count = TG._fused_linear_ce(th, tw, torch.from_numpy(labels),
                                       -100, n_chunks)
    total.backward()
    assert count.item() == n - 3
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-5)
    for got, ref in ((th.grad, jdh), (tw.grad, jdw)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n_chunks", [8, 3])
def test_chunked_softmax_ce_matches_jax(n_chunks):
    rs = np.random.RandomState(n_chunks + 1)
    n, v = 29, 50
    logits = (rs.randn(n, v) * 3).astype(np.float32)
    labels = rs.randint(0, v, (n,)).astype(np.int32)
    labels[[0, 9]] = -100

    def jloss(lg):
        return JG._chunked_softmax_ce(lg, jnp.asarray(labels), -100,
                                      n_chunks)[0]

    jl, jd = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    total, count = TG._chunked_softmax_ce(tl, torch.from_numpy(labels),
                                          -100, n_chunks)
    total.backward()
    assert count.item() == n - 2
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-5)
    jd = np.asarray(jd)
    assert np.abs(tl.grad.numpy() - jd).max() <= 1e-5 * np.abs(jd).max()


@pytest.mark.parametrize("fused", [True, False])
def test_criterion_on_logits_matches_jax(fused):
    """The criterion on [B, S, V] logits: the chunked CE (V >= 8192) or
    the plain cross_entropy, mean over non-ignored tokens."""
    rs = np.random.RandomState(5)
    v = 8192 if fused else 40
    logits = rs.randn(2, 3, v).astype(np.float32)
    labels = rs.randint(0, v, (2, 3)).astype(np.int32)
    labels[1, 2] = -100
    jl = JG.GPTPretrainingCriterion(fused=fused)(
        Tensor(jnp.asarray(logits)), Tensor(jnp.asarray(labels)))
    tl = TG.GPTPretrainingCriterion(fused=fused)(
        torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), float(np.asarray(jl._value)),
                               rtol=1e-5)


def test_criterion_refuses_hidden_states_it_cannot_fuse():
    cfg = TG.GPTConfig(vocab_size=32, hidden_size=8, num_layers=1,
                       num_heads=2, max_seq_len=8, fused_head_ce=True)
    model = TG.GPTForCausalLM(cfg, device="cpu").train()
    hidden = model(torch.zeros(1, 4, dtype=torch.int32))
    assert hidden.shape == (1, 4, 8)
    labels = torch.zeros(1, 4, dtype=torch.int64)
    for crit in (TG.GPTPretrainingCriterion(),
                 TG.GPTPretrainingCriterion(model=model, fused=False)):
        with pytest.raises(RuntimeError, match="fused_head_ce"):
            crit(hidden, labels)
    model.eval()             # serving: logits, whatever the flag
    assert model(torch.zeros(1, 4, dtype=torch.int32)).shape == (1, 4, 32)


# ------------------------------------------------------ (d) the optimizer
@pytest.mark.parametrize("opt", ["adamw", "adam"])
def test_optimizer_update_matches_apply_gradients(opt):
    rs = np.random.RandomState(0)
    shapes = {"w": (5, 7), "b": (7,)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    slots = {n: {"moment1": rs.randn(*s).astype(np.float32) * 0.1,
                 "moment2": rs.rand(*s).astype(np.float32) * 0.01}
             for n, s in shapes.items()}
    kw = dict(learning_rate=3e-3, weight_decay=0.1)
    jopt = (JAdamW if opt == "adamw" else JAdam)(**kw)
    jp, js = jopt.apply_gradients(
        {n: jnp.asarray(x) for n, x in params.items()},
        {n: jnp.asarray(x) for n, x in grads.items()},
        {"slots": {n: {k: jnp.asarray(x) for k, x in s.items()}
                   for n, s in slots.items()},
         "step": jnp.asarray(2, jnp.int32)})
    topt = (AdamW if opt == "adamw" else Adam)(**kw)
    tp = {n: torch.from_numpy(x.copy()) for n, x in params.items()}
    ts = {"slots": {n: {k: torch.from_numpy(x.copy()) for k, x in s.items()}
                    for n, s in slots.items()}, "step": 2}
    topt.apply_gradients(tp, {n: torch.from_numpy(x)
                              for n, x in grads.items()}, ts)
    assert ts["step"] == int(js["step"]) == 3
    for n in shapes:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=1e-6)
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(ts["slots"][n][k].numpy(),
                                       np.asarray(js["slots"][n][k]),
                                       atol=1e-6, rtol=1e-6)


def test_adamw_defaults_match_reference():
    t, j = AdamW(), JAdamW()
    assert (t._coeff, t._beta1, t._beta2, t._epsilon, t.get_lr()) == \
        (j._coeff, j._beta1, j._beta2, j._epsilon, j.get_lr())


# ------------------------------------------ (e) model gradients, (f) steps
TINY = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
            max_seq_len=128, fused_head_ce=True)    # bench.py:71-73


def _pair(cfg_kw, seed=0):
    P.seed(seed)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**cfg_kw))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**cfg_kw), device="cpu")
    params, _ = jm.functional_state()
    TG.load_reference_state(tm, {n: np.asarray(x)
                                 for n, x in params.items()})
    return jm, tm


def test_gpt_tiny_fused_ce_grads_match_jax():
    kw = dict(TINY, vocab_size=300, max_seq_len=32)
    jm, tm = _pair(kw)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 300, (2, 24)).astype(np.int32)
    labels = rs.randint(0, 300, (2, 24)).astype(np.int32)
    labels[0, :3] = -100
    jm.train()
    jcrit = JG.GPTPretrainingCriterion(model=jm)
    params, buffers = jm.functional_state()

    def loss_of(p):
        with jflags.trace_guard():
            with jm.bind_state(p, buffers):
                loss = jcrit(jm(Tensor(jnp.asarray(ids))),
                             Tensor(jnp.asarray(labels)))
        return loss._value

    jl, jg = jax.value_and_grad(loss_of)(params)
    tm.train()
    tl = TG.GPTPretrainingCriterion(model=tm)(tm(torch.from_numpy(ids)),
                                              torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    names = dict(tm.named_parameters())
    assert set(names) == set(jg)
    for n, p in names.items():
        ref = np.asarray(jg[n])
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (n, err)


def _jax_losses(amp, ids, labels, steps):
    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        jm, tm = _pair(TINY)
        model = fleet.distributed_model(jm)
        opt = fleet.distributed_optimizer(
            P.optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=1e-4))
        step = model.build_train_step(
            opt, JG.GPTPretrainingCriterion(model=jm), amp_dtype=amp)
        jids, jlab = P.to_tensor(ids, "int32"), P.to_tensor(labels, "int32")
        losses = [float(np.asarray(step(jids, jlab)._value))
                  for _ in range(steps)]
    finally:
        topology.reset_topology()
    return losses, tm


@pytest.mark.parametrize("amp,tol", [(None, 1e-4), ("bfloat16", 5e-3)])
def test_train_step_loss_trajectory_matches_jax(amp, tol):
    """5 AdamW steps (lr 1e-4, bench.py's optimizer) on one fixed batch;
    losses near 6.98.  Measured largest gap over the 5 steps (x86 CPU,
    torch 2.13, jax 0.9.0): f32 9.5e-7; bf16 AMP 8.2e-5 (bf16 rounds at
    other places in the two frameworks, and the port's fused head rounds
    each chunk's logits to bf16 where JAX keeps the f32 accumulator).
    The bf16 tolerance leaves room for another CPU's bf16 matmul."""
    rs = np.random.RandomState(0)                 # bench.py:87
    ids = rs.randint(0, TINY["vocab_size"], (2, 128)).astype(np.int32)
    labels = rs.randint(0, TINY["vocab_size"], (2, 128)).astype(np.int32)
    jl, tm = _jax_losses(amp, ids, labels, 5)
    step = build_train_step(tm, AdamW(parameters=tm.parameters(),
                                      learning_rate=1e-4),
                            TG.GPTPretrainingCriterion(model=tm),
                            amp_dtype=amp)
    tl = step.run_steps(ids, labels, repeat=5)
    assert tl.dtype == torch.float32 and tl.shape == (5,)
    np.testing.assert_allclose(tl.numpy(), jl, atol=tol, rtol=0)
    assert tl[-1] < tl[0]
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_train_step_refuses_what_is_not_ported():
    tm = TG.GPTForCausalLM(TG.GPTConfig(**dict(TINY, num_layers=1)),
                           device="cpu")
    crit = TG.GPTPretrainingCriterion(model=tm)
    for kw in (dict(sharding_stage=1), dict(collective_precision="int8")):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            build_train_step(tm, AdamW(), crit, **kw)
    # ported: the guard, the checkpoint manager, the preemption guard
    # and `recompute` (taken and, as in JAX, a model option);
    # tests/test_torch_resilient_train.py holds them against the JAX step
    for kw in (dict(guard=True), dict(checkpoint_manager=object()),
               dict(preemption_guard=object()), dict(recompute=True)):
        build_train_step(tm, AdamW(), crit, **kw)
    # ported: global-norm clipping (tests/test_torch_encoder.py holds it
    # against the JAX step)
    assert build_train_step(tm, AdamW(), crit,
                            grad_clip_norm=1.0).grad_clip_norm == 1.0
    with pytest.raises(TypeError, match="bogus"):
        build_train_step(tm, AdamW(), crit, bogus=1)
    build_train_step(tm, AdamW(), crit, sharding_stage=0)   # single device
    bf = TG.GPTForCausalLM(TG.GPTConfig(**dict(TINY, num_layers=1)),
                           device="cpu", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        build_train_step(bf, AdamW(), crit)


def test_run_steps_over_a_leading_step_axis_equals_calls():
    kw = dict(TINY, num_layers=1, vocab_size=64, hidden_size=32)
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 64, (3, 2, 16)).astype(np.int32)
    labels = rs.randint(0, 64, (3, 2, 16)).astype(np.int32)
    losses = []
    for scan in (True, False):
        tm = TG.GPTForCausalLM(TG.GPTConfig(**kw), device="cpu", seed=4)
        step = build_train_step(tm, AdamW(learning_rate=1e-3),
                                TG.GPTPretrainingCriterion(model=tm))
        losses.append(step.run_steps(ids, labels) if scan else
                      torch.stack([step(i, l) for i, l in zip(ids, labels)]))
    torch.testing.assert_close(losses[0], losses[1], rtol=0, atol=0)
