"""The port's AMP (``paddle_tpu_torch/amp``) against the JAX package's
(``paddle_tpu/amp``), on the CPU:

  * the cast gate: under `auto_cast` (bf16 and f16, the default lists and
    custom ones) every white- or black-listed op of `gpt_tiny`'s forward
    and loss (both heads: the fused head + CE and the tied logits + CE)
    runs at the dtype the JAX package runs it at, read from both
    packages' `debugging` operator stats; the losses agree within 2e-2;
    the matmul case of ``tests/test_autograd.py:180``; outside
    `auto_cast` nothing is cast;
  * `decorate(level="O2")`: parameter dtypes, ``multi_precision`` on the
    optimizer, and after one eager step the f32 masters of JAX's
    `state_dict` keys;
  * `GradScaler`: the guard ladder of ``tests/test_resilience.py:393``
    run against both packages; a forced overflow (the loss times inf)
    skips the step bit for bit (parameters, slots, step count), halves
    the scale and reports an "amp" skip, in both packages; the scale's
    trajectory over a run equals JAX's; `minimize` and `state_dict`
    round-trip;
  * `debugging.check_numerics`;
  * `observability.goodput` (a copy of the JAX module, held by the drift
    test): the JAX tests' `partition` cases.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import amp as jamp
from paddle_tpu.models import gpt as JG
from paddle_tpu.resilience import StepGuard as JStepGuard
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.observability import goodput
from paddle_tpu_torch.ops import matmul
from paddle_tpu_torch.optimizer import optimizer as TO
from paddle_tpu_torch.resilience import StepGuard

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores
torch.set_num_threads(1)

CFG = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=32)


def _gpt_pair(fused):
    kw = dict(CFG, fused_head_ce=fused)
    P.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**kw))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**kw), device="cpu")
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    jm.train()
    tm.train()
    return jm, tm


def _listed(stats, extra=()):
    names = tamp.WHITE_LIST | tamp.BLACK_LIST | set(extra)
    return {n: d for n, d in stats.items() if n in names}


@pytest.mark.parametrize("custom", [None, "custom"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("fused", [True, False])
def test_gpt_tiny_op_dtypes_equal_jax(fused, dtype, custom):
    jm, tm = _gpt_pair(fused)
    lists = {}
    if custom:
        # linear pinned to f32, layer_norm moved to the AMP dtype
        lists = dict(custom_black_list={"linear"},
                     custom_white_list={"layer_norm"})
    ids = np.random.RandomState(1).randint(0, 300, (2, 16)).astype(np.int32)
    jamp.debugging.enable_operator_stats_collection()
    with jamp.auto_cast(dtype=dtype, **lists):
        jcrit = JG.GPTPretrainingCriterion(model=jm) if fused \
            else JG.GPTPretrainingCriterion(fused=False)
        jl = jcrit(jm(P.to_tensor(ids, "int32")), P.to_tensor(ids, "int32"))
    jstats = jamp.debugging.disable_operator_stats_collection()
    tamp.debugging.enable_operator_stats_collection()
    with tamp.auto_cast(dtype=dtype, **lists):
        tcrit = TG.GPTPretrainingCriterion(model=tm) if fused \
            else TG.GPTPretrainingCriterion(fused=False)
        tl = tcrit(tm(torch.from_numpy(ids)), torch.from_numpy(ids))
    tstats = tamp.debugging.disable_operator_stats_collection()
    want = _listed(jstats, lists.get("custom_white_list", ()))
    assert {"linear", "layer_norm", "scaled_dot_product_attention"} <= \
        set(want)
    assert ("cross_entropy" in want) != fused
    assert ("matmul" in want) != fused
    assert _listed(tstats) == want
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=2e-2)


def test_matmul_autocast_case():
    """``tests/test_autograd.py:180``: matmul outputs bf16 under
    `auto_cast`, f32 outside it."""
    x, y = torch.randn(4, 4), torch.randn(4, 4)
    with tamp.auto_cast():
        z = matmul(x, y)
    assert z.dtype == torch.bfloat16
    assert matmul(x, y).dtype == torch.float32
    tamp.debugging.enable_operator_stats_collection()
    with tamp.auto_cast(custom_black_list={"matmul"}):
        assert matmul(x, y).dtype == torch.float32
    with tamp.auto_cast(enable=False):
        assert matmul(x.bfloat16(), y.bfloat16()).dtype == torch.bfloat16
    assert tamp.debugging.disable_operator_stats_collection() == {
        "matmul": {"bfloat16": 1, "float32": 1}}


def test_decorate_o2_matches_jax():
    P.seed(0)
    jm = P.nn.Sequential(P.nn.Linear(6, 8), P.nn.ReLU(), P.nn.Linear(8, 3))
    tm = tnn.Sequential(tnn.Linear(6, 8, device="cpu"), tnn.ReLU(),
                        tnn.Linear(8, 3, device="cpu"))
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    jopt = P.optimizer.AdamW(learning_rate=1e-2, parameters=jm.parameters())
    topt = TO.AdamW(learning_rate=1e-2, parameters=tm.parameters())
    params = list(tm.parameters())
    jm, jopt = jamp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    got = tamp.decorate(tm, topt, level="O2", dtype="bfloat16")
    assert got == (tm, topt) and topt._multi_precision is True
    assert list(tm.parameters()) == params      # the same Parameter objects
    assert [str(p.dtype).replace("torch.", "") for p in tm.parameters()] \
        == [str(p.dtype) for p in jm.parameters()] == ["bfloat16"] * 4
    x = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    with jamp.auto_cast(level="O2"):
        jloss = jm(P.to_tensor(x)).astype("float32").mean()
    jloss.backward()
    jopt.step()
    with tamp.auto_cast(level="O2"):
        tloss = tm(torch.from_numpy(x)).float().mean()
    tloss.backward()
    topt.step()
    ts, js = topt.state_dict(), jopt.state_dict()
    assert sorted(ts) == sorted(js)
    masters = [k for k in ts if k.endswith(".master_weight")]
    assert len(masters) == 4 and all(ts[k].dtype == torch.float32
                                     for k in masters)
    for k in masters:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k].numpy()),
                                   rtol=2e-2, atol=1e-3)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert tamp.decorate(tm, level="O1") is tm


# ------------------------------------------------------------ GradScaler
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_scaler_guard_interplay(pkg):
    """``tests/test_resilience.py:393`` against each package: overflows
    with room to shrink the scale are "amp" skips with no escalation; at
    the floor (or under static scaling) they count toward the ladder;
    a clean step resets the streak."""
    Guard, Scaler = (JStepGuard, jamp.GradScaler) if pkg == "jax" \
        else (StepGuard, tamp.GradScaler)
    g = Guard(max_consecutive_bad=3, raise_without_rollback=False)
    scaler = Scaler(init_loss_scaling=4.0).attach_guard(g)
    scaler._found_inf = True
    scaler.update()
    assert g.consecutive_bad == 0 and g.total_bad == 1
    scaler._scale = 1.0
    for _ in range(3):
        scaler._found_inf = True
        scaler.update()
    assert g.rollbacks == 1
    scaler._found_inf = False
    scaler.update()
    assert g.consecutive_bad == 0
    g2 = Guard(max_consecutive_bad=2, raise_without_rollback=False)
    s2 = Scaler(use_dynamic_loss_scaling=False).attach_guard(g2)
    for _ in range(2):
        s2._found_inf = True
        s2.update()
    assert g2.rollbacks == 1


def _mlp_pair():
    P.seed(3)
    jm = P.nn.Sequential(P.nn.Linear(6, 8), P.nn.ReLU(), P.nn.Linear(8, 3))
    tm = tnn.Sequential(tnn.Linear(6, 8, device="cpu"), tnn.ReLU(),
                        tnn.Linear(8, 3, device="cpu"))
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    return jm, tm


def test_forced_overflow_skips_bit_for_bit_and_halves_the_scale():
    """6 f16 O1 steps of AdamW behind a GradScaler(2**10,
    incr_every_n_steps=2) attached to a StepGuard, the loss times inf at
    step 3, in both packages: the overflowing step leaves the
    parameters, the slots and the step count bit for bit as they were,
    the scale trajectory equals JAX's (halved at the overflow, doubled
    every 2 clean steps), the guard counts one "amp" skip and no
    escalation, and the parameters agree with JAX's within 1e-2."""
    jm, tm = _mlp_pair()
    jopt = P.optimizer.AdamW(learning_rate=1e-2, parameters=jm.parameters())
    topt = TO.AdamW(learning_rate=1e-2, parameters=tm.parameters())
    jg = JStepGuard(max_consecutive_bad=2, raise_without_rollback=False)
    tg = StepGuard(max_consecutive_bad=2, raise_without_rollback=False)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    js = jamp.GradScaler(**kw).attach_guard(jg)
    ts = tamp.GradScaler(**kw).attach_guard(tg)
    rs = np.random.RandomState(5)
    scales = []
    for i in range(6):
        x = rs.randn(4, 6).astype(np.float32)
        y = rs.randint(0, 3, (4,)).astype(np.int32)
        bad = float("inf") if i == 2 else 1.0
        with jamp.auto_cast(dtype="float16"):
            jl = P.nn.functional.cross_entropy(jm(P.to_tensor(x)),
                                               P.to_tensor(y, "int32"))
        js.scale(jl * bad).backward()
        with tamp.auto_cast(dtype="float16"):
            tl = tnn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                              torch.from_numpy(y))
        ts.scale(tl * bad).backward()
        before = ([p.detach().clone() for p in tm.parameters()],
                  {k: v.clone() for k, v in topt.state_dict().items()
                   if isinstance(v, torch.Tensor)}, topt._step_count)
        js.step(jopt)
        js.update()
        jopt.clear_grad()
        ts.step(topt)
        skipped = ts._found_inf
        ts.update()
        topt.clear_grad()
        if i == 2:
            assert skipped
            assert all(torch.equal(a, b) for a, b in
                       zip(before[0], tm.parameters()))
            assert all(torch.equal(v, topt.state_dict()[k])
                       for k, v in before[1].items())
            assert topt._step_count == before[2] == 2
        else:
            assert not skipped
        scales.append((float(ts.get_loss_scaling()),
                       float(js.get_loss_scaling().numpy())))
    assert [t for t, _ in scales] == [j for _, j in scales]
    assert scales[2][0] == scales[1][0] / 2
    assert tg.total_bad == jg.total_bad == 1
    assert tg.rollbacks == jg.rollbacks == 0
    assert tg.consecutive_bad == jg.consecutive_bad == 0
    jp = {n: np.asarray(v) for n, v in jm.functional_state()[0].items()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[n], atol=1e-2)


def test_scaler_minimize_and_state_dict_round_trip():
    jm, tm = _mlp_pair()
    jopt = P.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    topt = TO.SGD(learning_rate=0.1, parameters=tm.parameters())
    js, ts = jamp.GradScaler(init_loss_scaling=8.0), \
        tamp.GradScaler(init_loss_scaling=8.0)
    x = np.random.RandomState(6).randn(4, 6).astype(np.float32)
    js.minimize(jopt, jm(P.to_tensor(x)).mean())
    ts.minimize(topt, tm(torch.from_numpy(x)).mean())
    jp = {n: np.asarray(v) for n, v in jm.functional_state()[0].items()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[n], rtol=1e-6,
                                   atol=1e-7)
    assert ts.state_dict() == js.state_dict() == {
        "scale": 8.0, "good_steps": 1, "bad_steps": 0}
    other = tamp.GradScaler()
    other.load_state_dict(ts.state_dict())
    assert other.state_dict() == ts.state_dict()
    assert float(other.get_loss_scaling()) == 8.0
    off = tamp.GradScaler(enable=False)
    assert off.scale(torch.tensor(3.0)).item() == 3.0
    assert not off.is_enable() and ts.is_use_dynamic_loss_scaling()


def test_check_numerics():
    assert tamp.debugging.check_numerics(torch.ones(3), "op", "x")
    with pytest.raises(FloatingPointError, match="1 NaN, 1 Inf"):
        tamp.debugging.check_numerics(
            torch.tensor([1.0, float("nan"), float("inf")]), "op", "x")
    assert tamp.is_float16_supported() and tamp.is_bfloat16_supported()


# --------------------------------------------------------------- goodput
def _rec(wall_ms, n=1, compile=False):
    return {"phase": "step_stats", "wall_ms": wall_ms, "n_steps": n,
            "compile": compile}


def test_goodput_partition_categories():
    records = [_rec(1000.0, compile=True)] + [_rec(100.0)] * 10
    flight_events = [
        {"kind": "resilience.guard_skip", "t": 10.0},
        {"kind": "resilience.guard_rollback", "t": 11.0},
        {"kind": "resilience.retry", "t": 12.0, "delay": 0.5},
        {"kind": "resilience.drain_begin", "t": 20.0},
        {"kind": "resilience.drain_complete", "t": 20.25},
    ]
    rep = goodput.partition(records, flight_events, wall_s=4.0)
    assert rep["productive_s"] == pytest.approx(1.0)
    assert rep["lost"]["compile_s"] == pytest.approx(1.0)
    assert rep["lost"]["rollback_s"] == pytest.approx(0.2)
    assert rep["lost"]["retry_s"] == pytest.approx(0.5)
    assert rep["lost"]["preemption_s"] == pytest.approx(0.25)
    assert rep["lost"]["other_s"] == pytest.approx(4.0 - 1.0 - 1.95,
                                                   abs=1e-6)
    assert rep["productive_frac"] == pytest.approx(0.25)
    assert rep["steps"] == 10 and rep["rollback_events"] == 2


def test_goodput_without_wall_and_rows():
    rep = goodput.partition([_rec(200.0), _rec(50.0, compile=True)])
    assert rep["wall_s"] == pytest.approx(0.25)
    assert rep["lost"]["other_s"] == 0.0
    assert rep["productive_frac"] == pytest.approx(0.8)
    rows = goodput.metric_rows(goodput.partition([_rec(100.0)] * 4,
                                                 wall_s=1.0), degraded=True)
    assert [r["metric"] for r in rows] == ["goodput.productive_frac",
                                           "goodput.lost_frac"]
    assert all(r["degraded"] for r in rows) and rows[1]["lower_better"]
