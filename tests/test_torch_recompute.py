"""Dropout and activation recompute in the port's models, against the
JAX package's, on the CPU.

  * recompute (the ``tests/test_distributed.py:143`` contract on one
    device): `gpt_tiny` with ``recompute`` False, True,
    "dots_no_batch" and "dots" trains 2 AdamW steps to the same losses
    (the port's four bit for bit; the JAX step's with and without
    recompute within 1e-4 relative), and an unknown policy raises in
    both packages;
  * dropout under recompute: with dropout 0.1 the replay draws the
    forward's masks, so the gradients equal the plain backward's (f32,
    1e-6 of the largest, bit for bit on this host), eagerly and in the
    train step; the device generator is drawn from once a mask, by the
    forward only, and each replay draws the same number of masks from
    its own generator;
  * placement: the dropout sites of one training forward (their order,
    shapes and rate) are the JAX model's; train mode with dropout 0.1
    differs from dropout 0, eval mode equals it exactly; ``attn_dropout``
    (and LLaMA's ``dropout``, its attention's) changes nothing in
    either package (ROADMAP C2.6);
  * the incubate functionals: `fused_multi_head_attention` applies
    ``dropout_rate`` to its output (each element dropped, or scaled by
    1 / (1 - p)) and ``attn_dropout_rate`` to nothing, as JAX does.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import fleet, topology
from paddle_tpu.distributed.recompute import recompute as j_recompute
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.distributed import recompute as TR
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.nn import layers_common as TLC
from paddle_tpu_torch.nn.functional import common as TC
from paddle_tpu_torch.optimizer import AdamW

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

GPT = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, fused_head_ce=True)
POLICIES = (False, True, "dots_no_batch", "dots")


def _cfg(rc, **kw):
    return dict(GPT, recompute=bool(rc),
                recompute_policy=rc if isinstance(rc, str) else None, **kw)


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    return tuple(rs.randint(0, 96, (2, 16)).astype(np.int32)
                 for _ in range(2))


def _jax_losses(rc, params, ids, labels, steps=2):
    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        P.seed(0)
        jm = JG.GPTForCausalLM(JG.GPTConfig(**_cfg(rc)))
        jm.set_state_dict({n: P.to_tensor(v) for n, v in params.items()})
        model = fleet.distributed_model(jm)
        opt = fleet.distributed_optimizer(P.optimizer.AdamW(
            parameters=model.parameters(), learning_rate=1e-2))
        step = model.build_train_step(
            opt, JG.GPTPretrainingCriterion(model=jm))
        jb = (P.to_tensor(ids, "int32"), P.to_tensor(labels, "int32"))
        return [float(step(*jb)) for _ in range(steps)]
    finally:
        topology.reset_topology()


def test_recompute_policies_train_to_the_same_losses_as_jax():
    ids, labels = _batch()
    P.seed(0)
    params = {n: np.asarray(v) for n, v in JG.GPTForCausalLM(
        JG.GPTConfig(**GPT)).functional_state()[0].items()}
    port = {}
    for rc in POLICIES:
        tm = TG.GPTForCausalLM(TG.GPTConfig(**_cfg(rc)), device="cpu")
        TG.load_reference_state(tm, params)
        step = build_train_step(tm, AdamW(learning_rate=1e-2),
                                TG.GPTPretrainingCriterion(model=tm))
        port[rc] = step.run_steps(ids, labels, repeat=2)
    for rc in POLICIES[1:]:
        assert torch.equal(port[rc], port[False]), rc
    for rc in (False, True):
        np.testing.assert_allclose(port[rc].numpy(),
                                   _jax_losses(rc, params, ids, labels),
                                   rtol=1e-4, atol=0, err_msg=str(rc))


def test_unknown_policy_raises_in_both_packages():
    for fn in (TR.recompute, j_recompute):
        with pytest.raises(ValueError, match="recompute policy"):
            fn(lambda x: x, torch.ones(1), policy="dot")
    # with grad off too: the port checks before deciding to recompute
    with torch.no_grad(), pytest.raises(ValueError):
        TR.recompute(lambda x: x, torch.ones(1), policy="everything")
    assert TR.recompute(lambda x: x * 2, torch.ones(2),
                        policy="dots")[0] == 2


def _draws(monkeypatch):
    """Each dropout mask drawn: the generator it came from."""
    seen = []
    keep = TC._keep

    def counted(x, p, shape):
        seen.append(rng.generator(x.device))
        return keep(x, p, shape)

    monkeypatch.setattr(TC, "_keep", counted)
    return seen


@pytest.mark.parametrize("rc", POLICIES[1:])
def test_recompute_replays_the_forwards_dropout_masks(monkeypatch, rc):
    """Eager forward + backward with dropout 0.1: the gradients with
    recompute equal those without, and the device generator ends where
    the plain run leaves it; the forward draws 1 + 2 L masks from it,
    each replayed block 2 more from its own generator."""
    ids, labels = (torch.from_numpy(b) for b in _batch(2))
    out = {}
    for r in (False, rc):
        tm = TG.GPTForCausalLM(TG.GPTConfig(**_cfg(r, dropout=0.1)),
                               device="cpu", seed=3)
        tm.train()
        seen = _draws(monkeypatch)
        rng.seed(11)
        main = rng.generator("cpu")
        loss = TG.GPTPretrainingCriterion(model=tm)(tm(ids), labels)
        forward = len(seen)
        loss.backward()
        out[r] = ([p.grad.clone() for p in tm.parameters()],
                  main.get_state(), seen, forward)
        monkeypatch.undo()
    (g0, s0, d0, f0), (g1, s1, d1, f1) = out[False], out[rc]
    for a, b in zip(g0, g1):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()
        assert torch.equal(a, b)
    assert torch.equal(s0, s1)
    layers = GPT["num_layers"]
    assert f0 == f1 == len(d0) == 1 + 2 * layers
    assert all(g is rng.generator("cpu") for g in d1[:f1])
    replays = d1[f1:]
    assert len(replays) == 2 * layers
    assert all(g is not rng.generator("cpu") for g in replays)
    assert len({id(g) for g in replays}) == layers


def test_recompute_in_the_train_step_with_dropout(monkeypatch):
    """Three train steps with dropout 0.1 under full recompute equal the
    plain ones bit for bit; the step's replay generators are the ones
    its blocks replayed from, one a block."""
    ids, labels = _batch(3)
    runs = {}
    for rc in (False, True):
        tm = TG.GPTForCausalLM(TG.GPTConfig(**_cfg(rc, dropout=0.1)),
                               device="cpu", seed=4)
        step = build_train_step(tm, AdamW(learning_rate=1e-2),
                                TG.GPTPretrainingCriterion(model=tm))
        seen = _draws(monkeypatch)
        rng.seed(5)
        losses = step.run_steps(ids, labels, repeat=3)
        runs[rc] = (losses, [p.detach().clone() for p in tm.parameters()],
                    rng.generator("cpu").get_state(), list(seen), step)
        monkeypatch.undo()
    (l0, p0, s0, _, _), (l1, p1, s1, d1, step) = runs[False], runs[True]
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    gens = step._replay_gens.generators
    assert len(gens) == GPT["num_layers"]
    assert sum(g is gens[0] for g in d1) == 2 * 3     # 2 masks x 3 steps


def test_llama_recompute_matches_the_plain_backward():
    """LLaMA's blocks (rope inside) under each policy: the same loss and
    gradients as without recompute."""
    ids = torch.from_numpy(_batch(6)[0])
    grads = {}
    for rc in (False, True, "dots_no_batch"):
        cfg = TL.llama_tiny(vocab_size=96, hidden_size=32, num_layers=2,
                            num_heads=4, num_kv_heads=2, ffn_hidden=64,
                            recompute=bool(rc),
                            recompute_policy=rc if isinstance(rc, str)
                            else None)
        tm = TL.LlamaForCausalLM(cfg, device="cpu", seed=2)
        tm.train()
        logits = tm(ids)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 96), ids.reshape(-1).long())
        loss.backward()
        grads[rc] = [p.grad.clone() for p in tm.parameters()]
    for rc in (True, "dots_no_batch"):
        assert all(torch.equal(a, b) for a, b in zip(grads[rc],
                                                     grads[False]))


# ------------------------------------------------------------ placement
def _sites(monkeypatch):
    calls = []
    t_drop, j_drop = TLC.dropout, JF.dropout

    def t_rec(x, p=0.5, **kw):
        calls.append(("port", tuple(x.shape), p))
        return t_drop(x, p, **kw)

    def j_rec(x, p=0.5, **kw):
        calls.append(("jax", tuple(x.shape), p))
        return j_drop(x, p, **kw)

    monkeypatch.setattr(TLC, "dropout", t_rec)
    monkeypatch.setattr(JF, "dropout", j_rec)
    return calls


def test_dropout_sites_are_the_jax_models(monkeypatch):
    ids = _batch(7)[0]
    cfg = dict(GPT, fused_head_ce=False, dropout=0.1)
    P.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**cfg))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu")
    calls = _sites(monkeypatch)
    jm.train()
    tm.train()
    jm(Tensor(jnp.asarray(ids)))
    tm(torch.from_numpy(ids))
    monkeypatch.undo()
    jax_sites = [c[1:] for c in calls if c[0] == "jax"]
    port_sites = [c[1:] for c in calls if c[0] == "port"]
    assert port_sites == jax_sites
    assert len(port_sites) == 1 + 2 * GPT["num_layers"]
    assert all(p == 0.1 for _, p in port_sites)


def test_dropout_changes_training_only_and_attn_dropout_nothing():
    ids = torch.from_numpy(_batch(8)[0])
    P.seed(0)
    params = {n: np.asarray(v) for n, v in JG.GPTForCausalLM(
        JG.GPTConfig(**GPT)).functional_state()[0].items()}

    def logits(train, **kw):
        tm = TG.GPTForCausalLM(TG.GPTConfig(**dict(GPT, fused_head_ce=False,
                                                   **kw)), device="cpu")
        TG.load_reference_state(tm, params)
        tm.train(train)
        rng.seed(1)
        with torch.no_grad():
            return tm(ids)

    base = logits(True)
    assert not torch.equal(logits(True, dropout=0.1), base)
    assert torch.equal(logits(False, dropout=0.1), logits(False))
    assert torch.equal(logits(False), base)
    assert torch.equal(logits(True, attn_dropout=0.5), base)
    # the JAX model: attn_dropout is a no-op there too
    jout = []
    for attn in (0.0, 0.5):
        P.seed(0)
        jm = JG.GPTForCausalLM(JG.GPTConfig(**dict(GPT, fused_head_ce=False,
                                                   attn_dropout=attn)))
        jm.train()
        jout.append(np.asarray(jm(Tensor(jnp.asarray(ids.numpy())))._value))
    np.testing.assert_array_equal(jout[0], jout[1])
    np.testing.assert_allclose(base.numpy(), jout[0], rtol=1e-4, atol=1e-4)
    # LLaMA's dropout is its attention's: nothing in training either
    cfg = dict(vocab_size=96, hidden_size=32, num_layers=1, num_heads=4,
               ffn_hidden=64)
    outs = []
    for p in (0.0, 0.3):
        tm = TL.LlamaForCausalLM(TL.llama_tiny(dropout=p, **cfg),
                                 device="cpu", seed=0)
        tm.train()
        with torch.no_grad():
            outs.append(tm(ids))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("attn", [0.0, 0.4])
def test_fused_mha_dropout_matches_jax_semantics(attn):
    """`fused_multi_head_attention` in training: ``dropout_rate`` 0.25
    drops each output element or scales it by 1 / 0.75 (before the
    residual), ``attn_dropout_rate`` changes nothing; in both packages,
    against their own eval outputs, which agree with each other."""
    rs = np.random.RandomState(9)
    x = rs.randn(2, 6, 16).astype(np.float32)
    qkv = (rs.randn(3, 2, 8, 16) * 0.2).astype(np.float32)
    lin = (rs.randn(16, 16) * 0.2).astype(np.float32)

    def port(train, p):
        rng.seed(2)
        return TIF.fused_multi_head_attention(
            torch.from_numpy(x), torch.from_numpy(qkv),
            torch.from_numpy(lin), dropout_rate=p,
            attn_dropout_rate=attn, training=train).numpy()

    def jax(train, p):
        P.seed(2)
        return np.asarray(JIF.fused_multi_head_attention(
            Tensor(jnp.asarray(x)), Tensor(jnp.asarray(qkv)),
            Tensor(jnp.asarray(lin)), dropout_rate=p,
            attn_dropout_rate=attn, training=train)._value)

    for fn in (port, jax):
        ref = fn(False, 0.25) - x
        got = fn(True, 0.25) - x
        kept = np.abs(got) > 0
        assert 0 < kept.mean() < 1
        np.testing.assert_allclose(got[kept], ref[kept] / 0.75, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(fn(True, 0.0), fn(False, 0.25))
    np.testing.assert_allclose(port(False, 0.25), jax(False, 0.25),
                               rtol=1e-5, atol=1e-5)
