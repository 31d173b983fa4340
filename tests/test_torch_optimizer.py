"""The port's optimizers (``paddle_tpu_torch/optimizer/optimizer.py``)
against the JAX package's, on the CPU in float32.

  (1) every rule of the zoo, functional: 3 steps of `apply_gradients` on
      the same numpy parameters and gradients, with and without an
      `L2Decay` where the optimizer takes one: parameters and slots
      within rtol 1e-6 (atol 1e-7 for values that cross zero);
  (2) the eager loop ``loss.backward(); opt.step(); opt.clear_grad()``
      on a 2-layer MLP (every rule, with parameter groups: an lr
      multiplier and a weight-decay override, `ClipGradByGlobalNorm`,
      an `L2Decay`) and on `gpt_tiny` (Momentum): parameters within 1e-5
      (of the largest value) after 3 steps; `multi_precision` on bf16
      parameters (f32 masters within 1e-6, the bf16 parameters their
      casts); `state_dict` keys equal JAX's, and a JAX `state_dict`
      loaded into the port's optimizer continues to the same next step;
  (3) LBFGS and Rprop converge on the regression of
      ``tests/test_api_surface.py:213``, with iterates equal to JAX's
      within 1e-5;
  (4) `L1Decay` applies nothing in either package (pinned: the JAX
      rules read only `L2Decay`);
  and LBFGS has no functional rule in either package.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import gpt as JG
from paddle_tpu.optimizer import optimizer as JO
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import regularizer as TR
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.optimizer import optimizer as TO

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores
torch.set_num_threads(1)

# name -> (class, kwargs, takes an L2Decay as weight_decay)
ZOO = {
    "sgd": ("SGD", dict(learning_rate=0.1), True),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9), True),
    "nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  use_nesterov=True), True),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1), True),
    "adam": ("Adam", dict(learning_rate=0.01), True),
    "amsgrad": ("Adam", dict(learning_rate=0.01, amsgrad=True), True),
    "adamw": ("AdamW", dict(learning_rate=0.01, weight_decay=0.05), True),
    "adamax": ("Adamax", dict(learning_rate=0.01), True),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, momentum=0.5), True),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True), True),
    "lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.05),
             False),
    "adadelta": ("Adadelta", dict(learning_rate=1.0), True),
    "rprop": ("Rprop", dict(learning_rate=0.01), False),
}
CASES = [(n, d) for n, (_, _, l2) in ZOO.items()
         for d in ((None, "l2") if l2 else (None,))]


def _kw(name, decay):
    cls, kw, _ = ZOO[name]
    kw = dict(kw)
    if decay == "l2":
        kw["weight_decay"] = (TR.L2Decay(0.1), JO.L2Decay(0.1))
    return cls, kw


def _pair(name, decay, **more):
    """The port's and the JAX optimizer of one case."""
    cls, kw = _kw(name, decay)
    tkw, jkw = dict(kw, **more), dict(kw, **more)
    if decay == "l2":
        tkw["weight_decay"], jkw["weight_decay"] = kw["weight_decay"]
    return getattr(TO, cls), tkw, getattr(JO, cls), jkw


SHAPES = {"w": (5, 7), "b": (7,), "s": (3,)}


@pytest.mark.parametrize("name,decay", CASES)
def test_rule_matches_jax_apply_gradients(name, decay):
    """3 functional steps from step 0 on the same parameters and
    gradients (the rate each step from the optimizer)."""
    tcls, tkw, jcls, jkw = _pair(name, decay)
    rs = np.random.RandomState(len(name))
    params = {n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(3)]
    jopt, topt = jcls(**jkw), tcls(**tkw)
    jp = {n: jnp.asarray(x) for n, x in params.items()}
    js = jopt.init_state(jp)
    tp = {n: torch.from_numpy(x.copy()) for n, x in params.items()}
    ts = topt.init_state(tp)
    for g in grads:
        jp, js = jopt.apply_gradients(jp, {n: jnp.asarray(x)
                                           for n, x in g.items()}, js)
        topt.apply_gradients(tp, {n: torch.from_numpy(x)
                                  for n, x in g.items()}, ts)
    assert int(ts["step"]) == int(js["step"]) == 3
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7)
        assert set(ts["slots"][n]) == set(js["slots"][n])
        for k, v in js["slots"][n].items():
            np.testing.assert_allclose(ts["slots"][n][k].numpy(),
                                       np.asarray(v), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- (2) the eager loop
def _mlp_pair(seed=0, dtype=None):
    P.seed(seed)
    jm = P.nn.Sequential(P.nn.Linear(6, 16), P.nn.ReLU(),
                         P.nn.Linear(16, 4))
    tm = tnn.Sequential(tnn.Linear(6, 16, device="cpu"), tnn.ReLU(),
                        tnn.Linear(16, 4, device="cpu"))
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    if dtype is not None:
        jm.to(dtype=dtype)
        tm.to(getattr(torch, dtype))
    return jm, tm


def _groups(params, lr_mult=0.5, wd=0.2):
    """Two parameter groups: the first layer at half the rate, the
    second with its own weight decay."""
    params = list(params)
    return [{"params": params[:2], "learning_rate": lr_mult},
            {"params": params[2:], "weight_decay": wd}]


def _batches(n=3, seed=3):
    rs = np.random.RandomState(seed)
    return [(rs.randn(8, 6).astype(np.float32),
             rs.randint(0, 4, (8,)).astype(np.int32)) for _ in range(n)]


def _jax_eager(jm, jopt, batches):
    for x, y in batches:
        loss = P.nn.functional.cross_entropy(jm(P.to_tensor(x)),
                                             P.to_tensor(y, "int32"))
        loss.backward()
        jopt.step()
        jopt.clear_grad()


def _port_eager(tm, topt, batches):
    for x, y in batches:
        loss = tnn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                            torch.from_numpy(y))
        loss.backward()
        topt.step()
        topt.clear_grad()


def _assert_params(tm, jm, tol):
    jp = {n: np.asarray(v, np.float32)
          for n, v in jm.functional_state()[0].items()}
    for n, p in tm.named_parameters():
        ref = jp[n]
        err = np.abs(p.detach().float().numpy() - ref).max()
        assert err <= tol * max(1.0, np.abs(ref).max()), (n, err)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_eager_loop_with_groups_and_clip_matches_jax(name):
    """3 eager steps of a 2-layer MLP with parameter groups,
    ClipGradByGlobalNorm(0.5) and (where the rule takes one) an
    L2Decay(0.01)."""
    decay = "l2" if ZOO[name][2] else None
    tcls, tkw, jcls, jkw = _pair(name, decay)
    if decay:
        tkw["weight_decay"] = TR.L2Decay(0.01)
        jkw["weight_decay"] = JO.L2Decay(0.01)
    jm, tm = _mlp_pair()
    jopt = jcls(parameters=_groups(jm.parameters()),
                grad_clip=P.nn.ClipGradByGlobalNorm(0.5), **jkw)
    topt = tcls(parameters=_groups(tm.parameters()),
                grad_clip=tnn.ClipGradByGlobalNorm(0.5), **tkw)
    batches = _batches()
    _jax_eager(jm, jopt, batches)
    _port_eager(tm, topt, batches)
    _assert_params(tm, jm, 1e-5)
    assert all(p.grad is None for p in tm.parameters())
    assert topt._step_count == jopt._step_count == 3


def test_gpt_tiny_eager_momentum_matches_jax():
    """`gpt_tiny` widths, 2 layers, f32: 3 eager Momentum steps with
    ClipGradByGlobalNorm(1.0) and an L2Decay in both packages, losses
    within 1e-5 and every parameter within 1e-5 of the largest value.
    (Momentum, not Adam: the k part of each qkv bias has a gradient
    that is zero but for rounding, which Adam's normalisation turns
    into steps of either sign.)"""
    kw = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=32)
    P.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**kw))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**kw), device="cpu")
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    jm.train()
    tm.train()
    jopt = P.optimizer.Momentum(learning_rate=0.1,
                                parameters=jm.parameters(),
                                weight_decay=JO.L2Decay(1e-3),
                                grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
    topt = TO.Momentum(learning_rate=0.1, parameters=tm.parameters(),
                       weight_decay=TR.L2Decay(1e-3),
                       grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    jcrit = JG.GPTPretrainingCriterion()
    tcrit = TG.GPTPretrainingCriterion()
    rs = np.random.RandomState(2)
    for _ in range(3):
        ids = rs.randint(0, 300, (2, 16)).astype(np.int32)
        jl = jcrit(jm(P.to_tensor(ids, "int32")), P.to_tensor(ids, "int32"))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tcrit(tm(torch.from_numpy(ids)), torch.from_numpy(ids))
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5)
    _assert_params(tm, jm, 1e-5)


@pytest.mark.parametrize("name", ["adamw", "momentum", "lamb", "rprop"])
def test_multi_precision_masters_match_jax(name):
    """bf16 parameters with `multi_precision`: the same bf16 gradients
    given to both packages for 3 steps; the f32 masters within rtol 1e-6
    and every bf16 parameter the cast of its master."""
    tcls, tkw, jcls, jkw = _pair(name, None, multi_precision=True)
    jm, tm = _mlp_pair(dtype="bfloat16")
    jopt = jcls(parameters=jm.parameters(), **jkw)
    topt = tcls(parameters=list(tm.parameters()), **tkw)
    rs = np.random.RandomState(4)
    for _ in range(3):
        for jp, tp in zip(jm.parameters(), tm.parameters()):
            g = rs.randn(*tp.shape).astype(np.float32)
            tp.grad = torch.from_numpy(g).to(torch.bfloat16)
            jp.grad = Tensor(jnp.asarray(g, jnp.bfloat16))
        jopt.step()
        topt.step()
    for jp, tp in zip(jm.parameters(), tm.parameters()):
        master = topt._master_weights[id(tp)]
        np.testing.assert_allclose(
            master.numpy(), np.asarray(jopt._master_weights[id(jp)]),
            rtol=1e-6, atol=1e-7)
        assert tp.dtype == torch.bfloat16
        assert torch.equal(tp.detach(), master.to(torch.bfloat16))
    assert sorted(topt.state_dict()) == sorted(jopt.state_dict())


def test_state_dict_keys_and_jax_state_continue():
    """The port's `state_dict` has JAX's keys (``param_{i}.{slot}``,
    ``.master_weight``, ``@step``, ``LR_Scheduler``); a JAX optimizer's
    state loaded into the port's continues to the same next step."""
    jm, tm = _mlp_pair()
    jopt = P.optimizer.Adam(learning_rate=P.optimizer.lr.StepDecay(
        0.01, step_size=2), parameters=jm.parameters(), amsgrad=True)
    topt = TO.Adam(learning_rate=tlr.StepDecay(0.01, step_size=2),
                   parameters=list(tm.parameters()), amsgrad=True)
    batches = _batches(3, seed=7)
    _jax_eager(jm, jopt, batches[:2])
    jopt._learning_rate.step()
    _port_eager(tm, topt, batches[:1])
    jstate = jopt.state_dict()
    assert sorted(topt.state_dict()) == sorted(jstate)
    # the JAX state (and weights) into the port, then one more step each
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    topt.set_state_dict({k: (np.asarray(v.numpy()) if hasattr(v, "numpy")
                             else v) for k, v in jstate.items()})
    assert topt._step_count == 2 and topt.get_lr() == jopt.get_lr()
    _jax_eager(jm, jopt, batches[2:])
    _port_eager(tm, topt, batches[2:])
    _assert_params(tm, jm, 1e-5)
    for k, v in jopt.state_dict().items():
        if k not in ("@step", "LR_Scheduler"):
            np.testing.assert_allclose(topt.state_dict()[k].numpy(),
                                       np.asarray(v.numpy()), rtol=1e-5,
                                       atol=1e-7)


def test_minimize_is_backward_step_clear():
    jm, tm = _mlp_pair()
    jopt = P.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    topt = TO.SGD(learning_rate=0.1, parameters=tm.parameters())
    (x, y), = _batches(1)
    jopt.minimize(P.nn.functional.cross_entropy(jm(P.to_tensor(x)),
                                                P.to_tensor(y, "int32")))
    assert topt.minimize(tnn.functional.cross_entropy(
        tm(torch.from_numpy(x)), torch.from_numpy(y))) == (None, None)
    _assert_params(tm, jm, 1e-6)
    assert all(p.grad is None for p in tm.parameters())


# --------------------------------------------------- (3) LBFGS and Rprop
def _regression():
    rs = np.random.RandomState(0)
    xs = rs.randn(32, 3).astype(np.float32)
    ys = xs @ np.array([[1.5], [-2.0], [0.5]], np.float32)
    return xs, ys


def _linear_pair():
    P.seed(0)
    jl = P.nn.Linear(3, 1)
    tl = tnn.Linear(3, 1, device="cpu")
    load_reference_state(tl, {n: np.asarray(x) for n, x in
                              jl.functional_state()[0].items()})
    return jl, tl


def test_lbfgs_converges_with_jax_iterates():
    xs, ys = _regression()
    jl, tl = _linear_pair()
    jopt = P.optimizer.LBFGS(parameters=jl.parameters(), max_iter=10)
    topt = TO.LBFGS(parameters=tl.parameters(), max_iter=10)

    def jclosure():
        loss = ((jl(P.to_tensor(xs)) - P.to_tensor(ys)) ** 2).mean()
        loss.backward()
        return loss

    def tclosure():
        loss = ((tl(torch.from_numpy(xs)) - torch.from_numpy(ys)) ** 2
                ).mean()
        loss.backward()
        return loss

    jfinal, tfinal = jopt.step(jclosure), topt.step(tclosure)
    assert tfinal < 1e-3, tfinal
    np.testing.assert_allclose(tfinal, jfinal, atol=1e-5)
    _assert_params(tl, jl, 1e-5)
    assert len(topt._s_hist) == len(jopt._s_hist)


def test_rprop_converges_with_jax_iterates():
    xs, ys = _regression()
    jl, tl = _linear_pair()
    jopt = P.optimizer.Rprop(learning_rate=0.01, parameters=jl.parameters())
    topt = TO.Rprop(learning_rate=0.01, parameters=tl.parameters())
    losses = []
    for _ in range(30):
        jloss = ((jl(P.to_tensor(xs)) - P.to_tensor(ys)) ** 2).mean()
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = ((tl(torch.from_numpy(xs)) - torch.from_numpy(ys)) ** 2
                 ).mean()
        tloss.backward()
        topt.step()
        topt.clear_grad()
        losses.append(float(tloss))
    assert losses[-1] < losses[0] * 0.5, losses
    _assert_params(tl, jl, 1e-5)


def test_lbfgs_has_no_functional_rule_in_either_package():
    params = {"w": np.ones(3, np.float32)}
    jopt = P.optimizer.LBFGS()
    with pytest.raises(NotImplementedError):
        jopt.apply_gradients({"w": jnp.asarray(params["w"])},
                             {"w": jnp.ones(3)},
                             jopt.init_state({"w": jnp.ones(3)}))
    topt = TO.LBFGS()
    tp = {"w": torch.ones(3)}
    with pytest.raises(NotImplementedError, match="step\\(closure\\)"):
        topt.apply_gradients(tp, {"w": torch.ones(3)}, topt.init_state(tp))


# ------------------------------------------------------ (4) L1Decay: none
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_l1_decay_applies_nothing_in_either_package(name):
    """Pinned: the JAX rules read only `L2Decay` (`_wd_for` :158,
    `_functional_wd` :101), so an `L1Decay` changes nothing, eager or
    functional, in the JAX package and in the port."""
    tcls, tkw, jcls, jkw = _pair(name, None)
    batches = _batches(2, seed=9)
    runs = []
    for l1 in (False, True):
        jm, tm = _mlp_pair()
        extra_t = dict(weight_decay=TR.L1Decay(0.5)) if l1 else {}
        extra_j = dict(weight_decay=JO.L1Decay(0.5)) if l1 else {}
        jopt = jcls(parameters=jm.parameters(), **jkw, **extra_j)
        topt = tcls(parameters=tm.parameters(), **tkw, **extra_t)
        assert topt._functional_wd() == jopt._functional_wd() == 0.0
        _jax_eager(jm, jopt, batches)
        _port_eager(tm, topt, batches)
        runs.append((jm, tm))
    (j0, t0), (j1, t1) = runs
    for (n, a), b in zip(t0.named_parameters(), t1.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(j0.parameters(), j1.parameters()):
        assert np.array_equal(np.asarray(a.numpy()), np.asarray(b.numpy()))
