"""The optimizer zoo in the port's graphed train step
(`distributed.build_train_step`) against the JAX package's
`build_train_step` with the same optimizer, on the CPU in float32.

  * every functional rule but LBFGS: 2 steps of `gpt_tiny` widths at
    1 layer with the fused head + CE on one batch, from the same
    weights: losses within 1e-5 and every parameter within 1e-5 of the
    largest value after the steps (the k part of the qkv bias, whose
    gradient is zero but for rounding, left out);
  * LBFGS raises NotImplementedError in either step, at its first call;
  * Lamb's and RMSProp's (centered) state round-trips through the JAX
    package's checkpoint format under the JAX step's `train_state_dict`
    keys: the keys equal JAX's, and a fresh step loaded from the saved
    state continues to the same next loss and parameters bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.distributed import fleet, topology
from paddle_tpu.models import gpt as JG
from paddle_tpu.optimizer import optimizer as JO
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.optimizer import optimizer as TO

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores
torch.set_num_threads(1)

CFG = dict(vocab_size=256, hidden_size=64, num_layers=1, num_heads=4,
           max_seq_len=32, fused_head_ce=True)

ZOO = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=1e-3)),
    "adagrad": ("Adagrad", dict(learning_rate=0.05,
                                initial_accumulator_value=0.1)),
    "amsgrad": ("Adam", dict(learning_rate=1e-3, amsgrad=True)),
    "adamw": ("AdamW", dict(learning_rate=1e-3)),
    "adamax": ("Adamax", dict(learning_rate=1e-3)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=1e-3, momentum=0.5,
                                         centered=True)),
    "lamb": ("Lamb", dict(learning_rate=1e-3)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0)),
    "rprop": ("Rprop", dict(learning_rate=1e-3)),
}


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], (2, 16)).astype(np.int32),
            rs.randint(0, CFG["vocab_size"], (2, 16)).astype(np.int32))


def _jax_step(jm, jopt):
    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(jm)
    return model.build_train_step(fleet.distributed_optimizer(jopt),
                                  JG.GPTPretrainingCriterion(model=jm))


def _pair(name, seed=0):
    cls, kw = ZOO[name]
    P.seed(seed)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**CFG))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**CFG), device="cpu")
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    jopt = getattr(JO, cls)(parameters=jm.parameters(), **kw)
    step = build_train_step(tm, getattr(TO, cls)(**kw),
                            TG.GPTPretrainingCriterion(model=tm))
    return jm, jopt, tm, step


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_train_step_matches_jax(name):
    jm, jopt, tm, step = _pair(name)
    ids, labels = _batch()
    try:
        jstep = _jax_step(jm, jopt)
        jl = [float(np.asarray(jstep(P.to_tensor(ids, "int32"),
                                     P.to_tensor(labels, "int32"))._value))
              for _ in range(2)]
        jp = {k[len("param."):]: np.asarray(v.numpy())
              for k, v in jstep.train_state_dict().items()
              if k.startswith("param.")}
    finally:
        topology.reset_topology()
    tl = step.run_steps(ids, labels, repeat=2)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5)
    width = CFG["hidden_size"]
    for n, p in tm.named_parameters():
        got, ref = p.detach().numpy(), jp[n]
        if n.endswith("qkv_proj.bias"):
            # the k part of the bias shifts every score of a row alike:
            # its gradient is zero but for rounding, whose sign the
            # normalising rules (Adam, Adagrad, Rprop...) turn into a
            # full step either way; q and v are compared
            keep = np.r_[0:width, 2 * width:3 * width]
            got, ref = got[keep], ref[keep]
        err = np.abs(got - ref).max()
        assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (n, err)


def test_lbfgs_raises_in_either_train_step():
    P.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**CFG))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**CFG), device="cpu")
    ids, labels = _batch()
    try:
        jstep = _jax_step(jm, JO.LBFGS(parameters=jm.parameters()))
        with pytest.raises(NotImplementedError):
            jstep(P.to_tensor(ids, "int32"), P.to_tensor(labels, "int32"))
    finally:
        topology.reset_topology()
    step = build_train_step(tm, TO.LBFGS(),
                            TG.GPTPretrainingCriterion(model=tm))
    with pytest.raises(NotImplementedError, match="LBFGS"):
        step(ids, labels)


@pytest.mark.parametrize("name", ["lamb", "rmsprop_centered"])
def test_zoo_checkpoint_round_trips(name, tmp_path):
    jm, jopt, tm, step = _pair(name)
    ids, labels = _batch(1)
    try:
        jkeys = set(_jax_step(jm, jopt).train_state_dict())
    finally:
        topology.reset_topology()
    step.run_steps(ids, labels, repeat=2)
    assert set(step.train_state_dict()) == jkeys
    assert any(k.startswith("slot.") for k in jkeys)
    step.save_train_state(str(tmp_path / "ckpt"))
    _, _, tm2, fresh = _pair(name, seed=5)
    fresh.load_train_state(str(tmp_path / "ckpt"))
    assert int(fresh._state["step"]) == 2
    a = step(ids, labels)
    b = fresh(ids, labels)
    assert torch.equal(a, b)
    for (n, p), q in zip(tm.named_parameters(), tm2.parameters()):
        assert torch.equal(p, q), n
