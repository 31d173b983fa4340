"""Learning-rate schedulers, optimizers driven by them, the train step's
per-step rates, and gradient clipping in the port, against the JAX
package on the CPU.

  * each of the 17 schedulers of `optimizer/lr.py`, built with the same
    arguments in both packages and stepped 50 times, gives the same
    `get_lr()` sequence (exactly: the same Python arithmetic);
  * `ReduceOnPlateau` on a metric given as a float and as a 0-dim torch
    tensor; a `state_dict` round trip resumes a schedule;
  * `Momentum`, `Adam` and `AdamW` take a scheduler as their rate as the
    JAX optimizers do (`get_lr`, `set_lr`, `set_lr_scheduler`), and the
    train step's `run_steps(lrs=)` gives each step its rate;
  * `ClipGradByValue`, `ClipGradByNorm`, `ClipGradByGlobalNorm`,
    `clip_grad_norm_` and `clip_grad_value_` against JAX ``nn/clip.py``
    on the same gradients, f32 within 1e-6 relative.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.optimizer import lr as JL
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
from paddle_tpu_torch.optimizer import lr as TL

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

SCHEDULERS = {
    "NoamDecay": lambda L: L.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda L: L.PiecewiseDecay([5, 20, 30],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda L: L.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda L: L.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda L: L.PolynomialDecay(0.1, decay_steps=20,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay_cycle": lambda L: L.PolynomialDecay(
        0.1, decay_steps=15, end_lr=0.001, cycle=True),
    "LinearWarmup": lambda L: L.LinearWarmup(0.1, warmup_steps=10,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup_over_PolynomialDecay": lambda L: L.LinearWarmup(
        L.PolynomialDecay(0.1, decay_steps=30, end_lr=1e-4),
        warmup_steps=8, start_lr=1e-5, end_lr=0.1),
    "ExponentialDecay": lambda L: L.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda L: L.MultiStepDecay(0.5, milestones=[10, 25],
                                                 gamma=0.3),
    "StepDecay": lambda L: L.StepDecay(0.5, step_size=7, gamma=0.5),
    "LambdaDecay": lambda L: L.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda L: L.ReduceOnPlateau(0.5, patience=2,
                                                   factor=0.5, cooldown=1),
    "CosineAnnealingDecay": lambda L: L.CosineAnnealingDecay(0.5, T_max=20,
                                                             eta_min=0.01),
    "MultiplicativeDecay": lambda L: L.MultiplicativeDecay(
        0.5, lambda e: 0.9),
    "OneCycleLR": lambda L: L.OneCycleLR(0.1, total_steps=40),
    "OneCycleLR_linear": lambda L: L.OneCycleLR(
        0.1, total_steps=40, anneal_strategy="linear", phase_pct=0.25),
    "CyclicLR": lambda L: L.CyclicLR(0.01, 0.1, step_size_up=6),
    "CyclicLR_triangular2": lambda L: L.CyclicLR(
        0.01, 0.1, step_size_up=5, step_size_down=3, mode="triangular2"),
    "CyclicLR_exp_range": lambda L: L.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.97),
    "LinearLR": lambda L: L.LinearLR(0.5, total_steps=30),
    "CosineAnnealingWarmRestarts": lambda L: L.CosineAnnealingWarmRestarts(
        0.5, T_0=5, T_mult=2, eta_min=0.01),
}


def _metrics(i):
    """A plateauing, then rising, then falling loss for ReduceOnPlateau."""
    return 1.0 / (1 + i) if i < 10 else 0.1 + 0.001 * (i % 7)


def _sequence(make, L, steps=50, metric=float):
    sched = make(L)
    out = []
    for i in range(steps):
        out.append(sched.get_lr() if not isinstance(sched, L.ReduceOnPlateau)
                   else sched.last_lr)
        if isinstance(sched, L.ReduceOnPlateau):
            sched.step(metric(_metrics(i)))
        else:
            sched.step()
    return out


def test_every_scheduler_is_ported():
    assert sorted(TL.__all__) == sorted(JL.__all__)
    assert len(TL.__all__) == 18               # the base and 17 schedulers
    kinds = {name.split("_")[0] for name in SCHEDULERS}
    assert kinds == set(JL.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_jax(name):
    make = SCHEDULERS[name]
    got, want = _sequence(make, TL), _sequence(make, JL)
    assert got == want
    assert len(set(got)) > 1 and all(math.isfinite(v) for v in got)


def test_reduce_on_plateau_takes_floats_and_tensors():
    want = _sequence(SCHEDULERS["ReduceOnPlateau"], JL)
    assert _sequence(SCHEDULERS["ReduceOnPlateau"], TL,
                     metric=lambda v: torch.tensor(v)) == want
    sched = TL.ReduceOnPlateau(1.0, patience=0, factor=0.5)
    sched.step(None)                      # no metric: nothing happens
    assert sched.last_epoch == 0 and sched.get_lr() == 1.0
    for m in (1.0, 2.0, 3.0):
        sched.step(m)
    assert sched.get_lr() == 0.25


@pytest.mark.parametrize("name", ["CosineAnnealingDecay", "OneCycleLR",
                                  "StepDecay", "LinearLR"])
def test_state_dict_round_trip_resumes_the_schedule(name):
    make = SCHEDULERS[name]
    a = make(TL)
    for _ in range(13):
        a.step()
    b = make(TL)
    b.set_state_dict(a.state_dict())
    for _ in range(10):
        assert a.get_lr() == b.get_lr()
        a.step()
        b.step()
    assert b.state_dict() == a.state_dict()


@pytest.mark.parametrize("cls", [Momentum, Adam, AdamW])
def test_optimizers_take_a_scheduler(cls):
    """As JAX `Optimizer` :79-91: `get_lr` reads the scheduler, `set_lr`
    raises while one is set, `set_lr_scheduler` sets one."""
    jcls = getattr(P.optimizer, cls.__name__)
    sched, jsched = (SCHEDULERS["StepDecay"](L) for L in (TL, JL))
    opt = cls(learning_rate=sched)
    jopt = jcls(learning_rate=jsched, parameters=[])
    for _ in range(9):
        assert opt.get_lr() == jopt.get_lr()
        sched.step()
        jsched.step()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    fixed = cls(learning_rate=0.3)
    fixed.set_lr(0.2)
    assert fixed.get_lr() == 0.2
    fixed.set_lr_scheduler(TL.ExponentialDecay(0.5, gamma=0.5))
    assert fixed.get_lr() == 0.5


class _MSE(torch.nn.Module):
    def forward(self, out, label):
        return (out - label).square().mean()


def _linear_step(opt, **kw):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    return build_train_step(model, opt, _MSE(), **kw)


def test_train_step_rates_per_step():
    """`run_steps` consumes the scheduler's next rates (stepping it once a
    step, as JAX :496-506), `__call__` reads `get_lr()` and leaves the
    scheduler alone, and explicit `lrs` equal a sequence of single steps
    at those rates (the scheduler untouched)."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3).astype(np.float32)
    y = rs.randn(4, 2).astype(np.float32)
    sched = TL.StepDecay(0.1, step_size=1, gamma=0.5)
    a = _linear_step(Momentum(learning_rate=sched, momentum=0.0))
    la = a.run_steps(x, y, repeat=4)
    assert sched.last_epoch == 4
    b = _linear_step(Momentum(learning_rate=0.1, momentum=0.0))
    lb = []
    for lr in (0.1, 0.05, 0.025, 0.0125):
        b.optimizer.set_lr(lr)
        lb.append(b(x, y))
    assert torch.equal(la, torch.stack(lb))
    c = _linear_step(Momentum(learning_rate=sched, momentum=0.0))
    c(x, y)
    assert sched.last_epoch == 4
    d = _linear_step(Momentum(learning_rate=sched, momentum=0.0))
    ld = d.run_steps(x, y, repeat=4, lrs=[0.1, 0.05, 0.025, 0.0125])
    assert torch.equal(ld, la) and sched.last_epoch == 4
    for pa, pd in zip(a.model.parameters(), d.model.parameters()):
        assert torch.equal(pa, pd)
    with pytest.raises(ValueError, match="lrs must have shape"):
        d.run_steps(x, y, repeat=4, lrs=[0.1, 0.1])


# ------------------------------------------------------------- clipping
def _grads(seed=0):
    rs = np.random.RandomState(seed)
    shapes = [(4, 3), (3,), (2, 2, 2), (5,)]
    return [(rs.randn(*s) * (1 + i)).astype(np.float32)
            for i, s in enumerate(shapes)]


def _pairs(grads, need_clip=(True, True, False, True)):
    """(param, grad) pairs in each package; the third parameter opts out
    of clipping, and a fifth has no gradient."""
    tp, jp = [], []
    for g, nc in zip(grads, need_clip):
        t = torch.nn.Parameter(torch.zeros(g.shape))
        t.need_clip = nc
        j = P.create_parameter(list(g.shape), "float32")
        j.need_clip = nc
        tp.append((t, torch.from_numpy(g.copy())))
        jp.append((j, P.to_tensor(g)))
    tp.append((torch.nn.Parameter(torch.zeros(2)), None))
    jp.append((P.create_parameter([2], "float32"), None))
    return tp, jp


@pytest.mark.parametrize("name,args", [
    ("ClipGradByValue", (0.5,)), ("ClipGradByValue", (0.5, -0.2)),
    ("ClipGradByNorm", (1.0,)), ("ClipGradByNorm", (100.0,)),
    ("ClipGradByGlobalNorm", (1.0,)), ("ClipGradByGlobalNorm", (1e3,))])
def test_clip_classes_match_jax(name, args):
    tp, jp = _pairs(_grads())
    got = getattr(tnn, name)(*args)(tp)
    want = getattr(P.nn, name)(*args)(jp)
    for (_, g), (_, w) in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w.numpy())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    # the opted-out gradient is untouched
    assert torch.equal(got[2][1], tp[2][1])


@pytest.mark.parametrize("norm_type,max_norm", [(2.0, 1.0), (2.0, 1e3),
                                                (float("inf"), 0.5),
                                                (1.0, 2.0)])
def test_clip_grad_norm_and_value_match_jax(norm_type, max_norm):
    grads = _grads(1)
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    jps = [P.create_parameter(list(g.shape), "float32") for g in grads]
    for t, j, g in zip(tps, jps, grads):
        t.grad = torch.from_numpy(g.copy())
        j.grad = P.to_tensor(g)
    total = tnn.clip_grad_norm_(tps, max_norm, norm_type=norm_type)
    jtotal = P.nn.clip_grad_norm_(jps, max_norm, norm_type=norm_type)
    np.testing.assert_allclose(float(total), float(jtotal.numpy()),
                               rtol=1e-6)
    for t, j in zip(tps, jps):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(
            j.grad.numpy()), rtol=1e-6, atol=1e-7)
    tnn.clip_grad_value_(tps, 0.05)
    P.nn.clip_grad_value_(jps, 0.05)
    for t, j in zip(tps, jps):           # clipped from the scaled grads
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(
            j.grad.numpy()), rtol=1e-6, atol=1e-7)
        assert float(t.grad.abs().max()) <= float(np.float32(0.05))
