"""The port's train step as a long job runs it, against the JAX
package's, on the CPU: the in-step guard, the ``train.step`` fault
point, exact resume across the two packages, preemption safe points,
and the replay path of the guarded steps.

  * guard (``tests/test_resilience.py:337-391``): a fault-free guarded
    step equals the unguarded one bit for bit (a linear model with an
    MSE loss and a `gpt_tiny` with dropout); a NaN step is skipped with
    the parameters, slots and step kept and the next loss equal to the
    unfaulted one; K bad steps roll back to the saved checkpoint; each
    against the JAX step on the same weights and batch (f32, 1e-6);
  * resume: a `gpt_tiny` state the JAX step saves loads into the port's
    step, whose next 2 losses are within 1e-5 of the JAX step's, and the
    reverse (with a bf16 leaf beside the state); the keys, shapes and
    dtypes of `train_state_dict` are the JAX step's; the LR scheduler
    sidecar and the strict loader;
  * preemption: a tripped guard writes one emergency checkpoint and
    raises `TrainingPreempted`, then raises it again without saving;
  * the replay path (`core.graphs` with the stand-in graph of
    ``tests/test_torch_graphs.py``): guarded, poisoned and recomputed
    steps capture once and replay, equal to eager steps.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet, topology
from paddle_tpu.distributed.checkpoint import CheckpointManager as JCM
from paddle_tpu.distributed.checkpoint import load_state_dict as jload
from paddle_tpu.models import gpt as JG
from paddle_tpu.resilience import StepGuard as JStepGuard
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch.core import graphs as GR
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.distributed.checkpoint import (
    CheckpointManager, save_state_dict,
)
from paddle_tpu_torch.distributed.train_step import save_train_checkpoint
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as TLR
from paddle_tpu_torch.resilience import (
    InjectedFault, PreemptionGuard, StepGuard, TrainingPreempted, faults,
)

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

GPT = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, fused_head_ce=True)


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture
def one_device():
    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    yield
    topology.reset_topology()


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _linear_pair(guard=None, jguard=None, lr=0.1):
    """The JAX linear step and the port's on the same weights."""
    P.seed(0)
    jlin = jnn.Linear(8, 4)
    params, _ = jlin.functional_state()
    tlin = Linear(8, 4, device="cpu")
    TG.load_reference_state(tlin, {n: np.asarray(v)
                                   for n, v in params.items()})
    jm = fleet.distributed_model(jlin)
    jopt = P.optimizer.Adam(parameters=jm.parameters(), learning_rate=lr)
    jstep = jm.build_train_step(jopt, jnn.MSELoss(), guard=jguard)
    tstep = build_train_step(tlin, Adam(learning_rate=lr), _mse, guard=guard)
    return jstep, tstep


def _batch():
    rs = np.random.RandomState(1)
    return rs.randn(8, 8).astype(np.float32), rs.randn(8, 4).astype(
        np.float32)


def _jx(x, y):
    return P.to_tensor(x), P.to_tensor(y)


def _losses(step, batch, n):
    return [float(step(*batch)) for _ in range(n)]


def _params(step):
    return [p.detach().clone() for p in step._params.values()]


# ------------------------------------------------------------ the guard
def test_guarded_step_without_faults_is_the_unguarded_one(one_device):
    x, y = _batch()
    jplain, plain = _linear_pair()
    jguarded, guarded = _linear_pair(
        StepGuard(raise_without_rollback=False),
        JStepGuard(raise_without_rollback=False))
    ref, got = _losses(plain, (x, y), 5), _losses(guarded, (x, y), 5)
    assert got == ref                              # bit for bit
    assert all(torch.equal(a, b) for a, b in zip(_params(plain),
                                                 _params(guarded)))
    jref = _losses(jplain, _jx(x, y), 5)
    assert _losses(jguarded, _jx(x, y), 5) == jref
    np.testing.assert_allclose(got, jref, rtol=1e-6, atol=0)
    assert guarded.guard.total_steps == 5 and guarded.guard.total_bad == 0


def test_guarded_gpt_with_dropout_is_the_unguarded_one():
    """Token ids and dropout 0.1: the loss flag (x 1) and the select
    change no bit, and `run_steps` equals `__call__`s."""
    rs = np.random.RandomState(2)
    ids, labels = (rs.randint(0, 96, (2, 16)) for _ in range(2))
    runs = []
    for guard in (None, True, True):
        tm = TG.GPTForCausalLM(TG.GPTConfig(dropout=0.1, **GPT),
                               device="cpu", seed=1)
        step = build_train_step(tm, AdamW(learning_rate=1e-2),
                                TG.GPTPretrainingCriterion(model=tm),
                                guard=guard)
        rng.seed(7)
        losses = step.run_steps(ids, labels, repeat=3) if len(runs) != 2 \
            else torch.stack([step(ids, labels) for _ in range(3)])
        runs.append((losses, _params(step), int(step._state["step"])))
    for losses, params, n in runs[1:]:
        assert torch.equal(losses, runs[0][0]) and n == runs[0][2] == 3
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0][1]))


def test_nan_step_is_skipped_with_the_state_kept(one_device):
    x, y = _batch()
    tg = StepGuard(max_consecutive_bad=10, raise_without_rollback=False)
    jg = JStepGuard(max_consecutive_bad=10, raise_without_rollback=False)
    jstep, tstep = _linear_pair(tg, jg)
    tstep(x, y)
    jstep(*_jx(x, y))
    state = [t.clone() for t in tstep.train_state_dict().values()]
    with faults.inject("train.step", kind="nan", at=1):
        bad = float(tstep(x, y))
    with jfaults.inject("train.step", kind="nan", at=1):
        jbad = float(jstep(*_jx(x, y)))
    assert np.isnan(bad) and np.isnan(jbad)
    assert all(torch.equal(a, b) for a, b in
               zip(state, tstep.train_state_dict().values()))
    after, jafter = float(tstep(x, y)), float(jstep(*_jx(x, y)))
    ref = _linear_pair()[1]
    ref(x, y)
    assert after == float(ref(x, y))
    np.testing.assert_allclose(after, jafter, rtol=1e-6)
    for g in (tg, jg):
        assert g.total_bad == 1 and g.consecutive_bad == 0


def test_nan_in_a_token_batch_reaches_a_guarded_step():
    """A batch of token ids has no floating leaf to poison (the JAX
    step's fault leaves such a step as it is); the guarded port step
    multiplies the loss by its NaN flag for the dispatch, so the step
    is skipped, and the flag is back to 1 for the next."""
    rs = np.random.RandomState(3)
    ids, labels = (rs.randint(0, 96, (2, 16)) for _ in range(2))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**GPT), device="cpu", seed=1)
    g = StepGuard(raise_without_rollback=False)
    step = build_train_step(tm, AdamW(learning_rate=1e-2),
                            TG.GPTPretrainingCriterion(model=tm), guard=g)
    step(ids, labels)
    before = _params(step)
    with faults.inject("train.step", kind="nan", at=1):
        losses = step.run_steps(ids, labels, repeat=2)
    assert torch.isnan(losses).all() and g.total_bad == 2
    assert all(torch.equal(a, b) for a, b in zip(before, _params(step)))
    assert int(step._state["step"]) == 1 and float(step._poison) == 1.0
    assert torch.isfinite(step(ids, labels))


def test_unguarded_nan_fault_poisons_the_float_leaf_as_jax(one_device):
    x, y = _batch()
    jstep, tstep = _linear_pair()
    with faults.inject("train.step", kind="nan", at=1):
        bad = float(tstep(x, y))
    with jfaults.inject("train.step", kind="nan", at=1):
        jbad = float(jstep(*_jx(x, y)))
    assert np.isnan(bad) and np.isnan(jbad)
    assert all(torch.isnan(p).all() for p in _params(tstep))


def test_error_fault_raises_at_dispatch():
    x, y = _batch()
    tlin = Linear(8, 4, device="cpu")
    step = build_train_step(tlin, Adam(learning_rate=0.1), _mse, guard=True)
    before = _params(step)
    with faults.inject("train.step", kind="error", at=1):
        with pytest.raises(InjectedFault):
            step(x, y)
    assert all(torch.equal(a, b) for a, b in zip(before, _params(step)))
    assert int(step._state["step"]) == 0


def test_bad_steps_roll_back_to_the_saved_checkpoint(one_device, tmp_path):
    x, y = _batch()
    tg, jg = StepGuard(max_consecutive_bad=2), JStepGuard(
        max_consecutive_bad=2)
    jstep, tstep = _linear_pair(tg, jg)
    tstep.attach_checkpoint_manager(CheckpointManager(str(tmp_path / "t")))
    jstep.attach_checkpoint_manager(JCM(str(tmp_path / "j")))
    tstep(x, y)
    jstep(*_jx(x, y))
    tstep.save_checkpoint()
    jstep.save_checkpoint()
    saved = [t.clone() for t in tstep.train_state_dict().values()]
    with faults.inject("train.step", kind="nan", times=2):
        tstep(x, y)
        tstep(x, y)
    with jfaults.inject("train.step", kind="nan", times=2):
        jstep(*_jx(x, y))
        jstep(*_jx(x, y))
    assert tg.rollbacks == jg.rollbacks == 1
    assert all(torch.equal(a, b) for a, b in
               zip(saved, tstep.train_state_dict().values()))
    after, jafter = float(tstep(x, y)), float(jstep(*_jx(x, y)))
    assert np.isfinite(after)
    np.testing.assert_allclose(after, jafter, rtol=1e-6)


def test_rollback_without_a_manager_raises():
    tlin = Linear(8, 4, device="cpu")
    step = build_train_step(tlin, Adam(learning_rate=0.1), _mse,
                            guard=StepGuard(max_consecutive_bad=1))
    with pytest.raises(ValueError, match="CheckpointManager"):
        step.rollback()
    with pytest.raises(ValueError, match="CheckpointManager"):
        step.save_checkpoint()


# ------------------------------------------------------------ resume
def _jax_gpt_step(seed=0, dropout=0.0):
    P.seed(seed)
    jm = JG.GPTForCausalLM(JG.GPTConfig(dropout=dropout, **GPT))
    model = fleet.distributed_model(jm)
    opt = fleet.distributed_optimizer(P.optimizer.AdamW(
        parameters=model.parameters(), learning_rate=1e-2))
    return jm, model.build_train_step(
        opt, JG.GPTPretrainingCriterion(model=jm))


def _port_gpt_step(jm=None, seed=5, sched=None):
    tm = TG.GPTForCausalLM(TG.GPTConfig(**GPT), device="cpu", seed=seed)
    if jm is not None:
        params, _ = jm.functional_state()
        TG.load_reference_state(tm, {n: np.asarray(v)
                                     for n, v in params.items()})
    return build_train_step(tm, AdamW(learning_rate=sched or 1e-2),
                            TG.GPTPretrainingCriterion(model=tm))


def _gpt_batch(seed=4):
    rs = np.random.RandomState(seed)
    return tuple(rs.randint(0, 96, (2, 16)).astype(np.int32)
                 for _ in range(2))


def test_train_state_dict_has_the_jax_keys(one_device):
    jm, jstep = _jax_gpt_step()
    ids, labels = _gpt_batch()
    tstep = _port_gpt_step(jm)
    jstep(P.to_tensor(ids, "int32"), P.to_tensor(labels, "int32"))
    want = {k: (tuple(np.shape(v._value)), str(v._value.dtype))
            for k, v in jstep.train_state_dict().items()}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in tstep.train_state_dict().items()}
    assert got == want
    assert tstep.train_state_dict()["param.gpt.wte.weight"] is \
        tstep.model.gpt.wte.weight                 # the live tensors


def test_jax_train_state_resumes_in_the_port(one_device, tmp_path):
    """2 JAX steps, `save_train_state`, 2 more JAX steps; a port step
    built from other weights loads the checkpoint and its next 2 losses
    are the JAX step's within 1e-5."""
    jm, jstep = _jax_gpt_step()
    ids, labels = _gpt_batch()
    jb = (P.to_tensor(ids, "int32"), P.to_tensor(labels, "int32"))
    for _ in range(2):
        jstep(*jb)
    jstep.save_train_state(str(tmp_path))
    jnext = _losses(jstep, jb, 2)
    tstep = _port_gpt_step(seed=9)
    tstep.load_train_state(str(tmp_path))
    assert int(tstep._state["step"]) == 2
    np.testing.assert_allclose(_losses(tstep, (ids, labels), 2), jnext,
                               rtol=1e-5, atol=0)


def test_port_train_state_resumes_in_jax(one_device, tmp_path):
    """The reverse, with a bf16 leaf saved beside the state: the JAX
    step's next 2 losses are the port's within 1e-5, and the bf16 leaf
    loads into a JAX bf16 tensor bit for bit."""
    jm, jstep = _jax_gpt_step(seed=3)
    tstep = _port_gpt_step(jm)
    ids, labels = _gpt_batch()
    for _ in range(2):
        tstep(ids, labels)
    probe = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)
                        ).to(torch.bfloat16)
    save_train_checkpoint({**tstep.train_state_dict(),
                           "buffer.bf16_probe": probe}, str(tmp_path))
    tnext = _losses(tstep, (ids, labels), 2)
    jm2, jstep2 = _jax_gpt_step(seed=11)
    jstep2.load_train_state(str(tmp_path))
    jb = (P.to_tensor(ids, "int32"), P.to_tensor(labels, "int32"))
    np.testing.assert_allclose(_losses(jstep2, jb, 2), tnext, rtol=1e-5,
                               atol=0)
    from paddle_tpu.core.tensor import Tensor

    tgt = {"buffer.bf16_probe": Tensor(jnp.zeros((3, 5), jnp.bfloat16))}
    jload(tgt, str(tmp_path))
    assert np.array_equal(
        np.asarray(tgt["buffer.bf16_probe"]._value).view(np.uint16),
        probe.view(torch.int16).numpy().view(np.uint16))


def test_resume_is_strict_and_carries_the_scheduler(tmp_path):
    ids, labels = _gpt_batch()
    sched = TLR.StepDecay(1e-2, step_size=2, gamma=0.5)
    step = _port_gpt_step(sched=sched)
    for _ in range(3):
        step(ids, labels)
        sched.step()
    step.save_train_state(str(tmp_path / "ck"))
    assert os.path.exists(tmp_path / "ck" / "lr_scheduler.json")
    sched2 = TLR.StepDecay(1e-2, step_size=2, gamma=0.5)
    fresh = _port_gpt_step(seed=8, sched=sched2)
    fresh.load_train_state(str(tmp_path / "ck"))
    assert sched2.last_epoch == sched.last_epoch and \
        sched2() == sched()
    assert all(torch.equal(a, b) for a, b in zip(
        step.train_state_dict().values(), fresh.train_state_dict().values()))
    # a float-rate checkpoint cannot resume a scheduled run
    plain = _port_gpt_step()
    plain.save_train_state(str(tmp_path / "plain"))
    with pytest.raises(ValueError, match="lr_scheduler.json"):
        _port_gpt_step(sched=TLR.StepDecay(1e-2, step_size=2)) \
            .load_train_state(str(tmp_path / "plain"))
    # a checkpoint missing leaves is refused
    partial = dict(list(step.train_state_dict().items())[:3])
    save_state_dict(partial, str(tmp_path / "partial"))
    with pytest.raises(ValueError, match="missing"):
        fresh.load_train_state(str(tmp_path / "partial"))


# ------------------------------------------------------------ preemption
def test_preemption_saves_once_and_raises_again(tmp_path):
    ids, labels = _gpt_batch()
    step = _port_gpt_step()
    mgr = CheckpointManager(str(tmp_path))
    guard = PreemptionGuard(signals=())
    step.attach_checkpoint_manager(mgr).attach_preemption_guard(guard)
    step(ids, labels)
    guard.trip("maintenance")
    with pytest.raises(TrainingPreempted) as first:
        step(ids, labels)
    assert first.value.step == 1 and mgr.checkpoints() == [1]
    assert first.value.checkpoint_dir == mgr._dir(1)
    assert int(step._state["step"]) == 1        # tripped before the step
    with pytest.raises(TrainingPreempted) as again:
        step.run_steps(ids, labels, repeat=2)
    assert again.value is first.value and mgr.checkpoints() == [1]
    fresh = _port_gpt_step(seed=6)
    fresh.load_train_state(mgr.latest_path())
    assert all(torch.equal(a, b) for a, b in zip(
        step.train_state_dict().values(), fresh.train_state_dict().values()))
    # without a manager: raised, nothing saved
    bare = _port_gpt_step().attach_preemption_guard(guard)
    with pytest.raises(TrainingPreempted) as none:
        bare(ids, labels)
    assert none.value.checkpoint_dir is None


# ------------------------------------------------------------ replay path
class _BodyGraph:
    """`GR.Graph` on the CPU: the capture runs nothing, a replay runs the
    captured body (``tests/test_torch_graphs.py``)."""

    made = []

    def __init__(self, body, stream, pool=None, generators=()):
        self.body, self.outputs, self.replays = body, torch.zeros(()), 0
        self.generators = tuple(generators)
        _BodyGraph.made.append(self)

    def replay(self):
        self.replays += 1
        self.outputs = self.body()


def _cpu_replay(monkeypatch):
    _BodyGraph.made = []
    monkeypatch.setattr(GR, "Graph", _BodyGraph)
    monkeypatch.setattr(GR, "warm_up", lambda body, stream: body())
    monkeypatch.setattr(GR, "capture_stream", lambda device: "stream")


@pytest.mark.parametrize("kind", ["guarded", "poisoned", "recompute"])
def test_resilient_steps_capture_once_and_replay(monkeypatch, kind):
    """Through the replay path: one capture, the other steps replays
    (a poisoned dispatch too: the flag, not a new capture), every loss
    and parameter equal to eager steps from the same generator state.
    A recomputed step registers its replay generators with the graph."""
    ids, labels = _gpt_batch(5)
    cfg = dict(GPT, dropout=0.1, recompute=kind == "recompute")

    def make():
        tm = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu", seed=2)
        return build_train_step(
            tm, AdamW(learning_rate=1e-2),
            TG.GPTPretrainingCriterion(model=tm),
            guard=StepGuard(raise_without_rollback=False)
            if kind != "recompute" else None)

    def run(step, replay):
        rng.seed(4)
        go = step._replay if replay else step._run
        placed = step._place((ids, labels))
        out = [go([placed] * 2, [1e-2] * 2,
                  None if step.guard is None else torch.ones(2, dtype=bool))]
        if kind == "poisoned":
            step._poison.fill_(float("nan"))
            out.append(go([placed], [1e-2], torch.ones(1, dtype=bool)))
            step._poison.fill_(1.0)
        out.append(go([placed] * 2, [1e-2] * 2,
                      None if step.guard is None else torch.ones(2,
                                                                 dtype=bool)))
        return torch.cat(out), _params(step)

    eager = run(make(), False)
    _cpu_replay(monkeypatch)
    graphed = make()
    replayed = run(graphed, True)
    monkeypatch.undo()
    assert len(_BodyGraph.made) == 1
    assert _BodyGraph.made[0].replays == (4 if kind == "poisoned" else 3)
    torch.testing.assert_close(replayed[0], eager[0], rtol=0, atol=0,
                               equal_nan=True)
    assert all(torch.equal(a, b) for a, b in zip(replayed[1], eager[1]))
    if kind == "poisoned":
        assert torch.isnan(replayed[0][2]) and torch.isfinite(
            replayed[0][[0, 1, 3, 4]]).all()
    if kind == "recompute":
        gens = graphed._replay_gens.generators
        assert len(gens) == GPT["num_layers"]
        assert _BodyGraph.made[0].generators == (graphed.generator, *gens)


# ------------------------------------------ the committed JAX checkpoint
# A checkpoint the JAX package's train step wrote, kept in the repo for
# the card test of the cross-package resume (the card's machine has no
# JAX): a `gpt_tiny`-shaped model after 2 AdamW steps, and the JAX
# step's next 2 losses.  Rewrite it with
#     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_resilient_train.py
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "jax_gpt_train_state")
FIXTURE_CFG = dict(vocab_size=64, hidden_size=16, num_layers=1,
                   num_heads=2, max_seq_len=8, fused_head_ce=True)


def write_jax_fixture(path):
    """2 JAX AdamW(1e-2) steps of the fixture model (weights from
    `P.seed(0)`) on one batch (`RandomState(0)`, B2 x 8),
    `save_train_state(path)`, then 2 more steps: their losses go to
    ``expected.json``."""
    import json

    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        P.seed(0)
        jm = JG.GPTForCausalLM(JG.GPTConfig(**FIXTURE_CFG))
        model = fleet.distributed_model(jm)
        opt = fleet.distributed_optimizer(P.optimizer.AdamW(
            parameters=model.parameters(), learning_rate=1e-2))
        step = model.build_train_step(
            opt, JG.GPTPretrainingCriterion(model=jm))
        rs = np.random.RandomState(0)
        ids, labels = (rs.randint(0, 64, (2, 8)).astype(np.int32)
                       for _ in range(2))
        jb = (P.to_tensor(ids, "int32"), P.to_tensor(labels, "int32"))
        for _ in range(2):
            step(*jb)
        step.save_train_state(path)
        losses = _losses(step, jb, 2)
    finally:
        topology.reset_topology()
    with open(os.path.join(path, "expected.json"), "w") as f:
        json.dump({"config": FIXTURE_CFG, "batch_seed": 0,
                   "learning_rate": 1e-2, "steps_before": 2,
                   "next_losses": losses}, f, indent=1)
        f.write("\n")


def test_committed_jax_checkpoint_is_what_jax_writes(tmp_path):
    """The JAX package rewrites the committed checkpoint with the same
    keys, shapes and dtypes and the same next losses (within 1e-6; the
    values themselves may move by a few ulps under another XLA compile,
    and Adam turns a near-zero gradient's rounding into a step of +-lr);
    the port's step resumes from the committed one to those losses
    within 1e-5."""
    import json

    from paddle_tpu_torch.distributed.checkpoint.api import _load_metadata

    write_jax_fixture(str(tmp_path))
    fresh, kept = _load_metadata(str(tmp_path)), _load_metadata(FIXTURE)
    assert {k: (tuple(v["global_shape"]), v["dtype"])
            for k, v in fresh.state_dict_metadata.items()} == \
        {k: (tuple(v["global_shape"]), v["dtype"])
         for k, v in kept.state_dict_metadata.items()}
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        want = json.load(f)
    with open(tmp_path / "expected.json") as f:
        np.testing.assert_allclose(json.load(f)["next_losses"],
                                   want["next_losses"], rtol=1e-6)
    tm = TG.GPTForCausalLM(TG.GPTConfig(**want["config"]), device="cpu",
                           seed=7)
    step = build_train_step(tm, AdamW(learning_rate=want["learning_rate"]),
                            TG.GPTPretrainingCriterion(model=tm))
    step.load_train_state(FIXTURE)
    assert int(step._state["step"]) == want["steps_before"]
    rs = np.random.RandomState(want["batch_seed"])
    ids, labels = (rs.randint(0, 64, (2, 8)).astype(np.int32)
                   for _ in range(2))
    np.testing.assert_allclose(_losses(step, (ids, labels), 2),
                               want["next_losses"], rtol=1e-5)


if __name__ == "__main__":
    os.makedirs(FIXTURE, exist_ok=True)
    for name in os.listdir(FIXTURE):
        os.remove(os.path.join(FIXTURE, name))
    write_jax_fixture(FIXTURE)
    print(f"wrote {FIXTURE}")
