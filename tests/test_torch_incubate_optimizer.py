"""The port's `incubate.optimizer` and `incubate.asp` against the JAX
package's, on the CPU.

A small MLP (8 -> 16 -> relu -> 4) starts from the JAX model's weights,
carried by `load_reference_state`; both packages take the same 12 seeded
batches through ``loss.backward(); opt.step(); opt.clear_grad()`` with
an MSE loss: `LookAhead` over SGD and over AdamW, `ModelAverage` beside
SGD (a window of 4, so the sums are rescaled) with `apply` / `restore`,
and `DistributedFusedLamb`.  Parameters after every step within 1e-5 of
the largest reference value (f32).  `tests/test_domains.py:191-230` and
`tests/test_quant_asp.py:65-83` are mirrored on the port, and ASP's masks,
pruning and `decorate` are held to JAX's (masks bit for bit).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
from paddle_tpu.incubate import asp as jasp
from paddle_tpu.incubate import optimizer as jopt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt_base
from paddle_tpu_torch.incubate import asp as tasp
from paddle_tpu_torch.incubate import optimizer as topt
from paddle_tpu_torch.models import load_reference_state

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

TOL = 1e-5      # f32, of the largest reference value
STEPS = 12


def _held(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), (what, err)


def _mlp_pair(seed=0, dims=(8, 16, 4)):
    P.seed(seed)
    jm = jnn.Sequential(jnn.Linear(dims[0], dims[1]), jnn.ReLU(),
                        jnn.Linear(dims[1], dims[2]))
    params, _ = jm.functional_state()
    tm = tnn.Sequential(
        tnn.Linear(dims[0], dims[1], device="cpu"), tnn.ReLU(),
        tnn.Linear(dims[1], dims[2], device="cpu"))
    load_reference_state(tm, {n: np.asarray(v) for n, v in params.items()})
    return jm, tm


def _batches(dims=(8, 16, 4)):
    rs = np.random.RandomState(1)
    return [(rs.randn(6, dims[0]).astype(np.float32),
             rs.randn(6, dims[-1]).astype(np.float32))
            for _ in range(STEPS)]


def _jax_step(jm, opt, x, y):
    loss = ((jm(P.to_tensor(x)) - P.to_tensor(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.numpy())


def _port_step(tm, opt, x, y):
    loss = ((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


def _params_held(jm, tm, what):
    jp = dict(jm.functional_state()[0])
    for n, p in tm.named_parameters():
        _held(p, jp[n], f"{what} {n}")


INNER = {  # name: (JAX optimizer, port optimizer) over the parameters
    "sgd": (lambda ps: P.optimizer.SGD(learning_rate=0.1, parameters=ps),
            lambda ps: topt_base.SGD(learning_rate=0.1, parameters=ps)),
    "adamw": (lambda ps: P.optimizer.AdamW(learning_rate=0.01,
                                           parameters=ps),
              lambda ps: topt_base.AdamW(learning_rate=0.01, parameters=ps)),
}


@pytest.mark.parametrize("alpha,k", [(0.5, 2), (0.8, 5)])
@pytest.mark.parametrize("inner", sorted(INNER))
def test_lookahead_matches_jax_over_12_steps(inner, alpha, k):
    jm, tm = _mlp_pair()
    mk_j, mk_t = INNER[inner]
    jo = jopt.LookAhead(mk_j(jm.parameters()), alpha=alpha, k=k)
    to = topt.LookAhead(mk_t(list(tm.parameters())), alpha=alpha, k=k)
    for i, (x, y) in enumerate(_batches()):
        lj, lt = _jax_step(jm, jo, x, y), _port_step(tm, to, x, y)
        assert abs(lj - lt) <= TOL * max(abs(lj), 1.0), (i, lj, lt)
        _params_held(jm, tm, f"step {i}")
    sd, jsd = to.state_dict(), jo.state_dict()
    assert sd["steps"] == jsd["steps"] == STEPS
    assert len(sd["slow"]) == len(jsd["slow"]) == 4
    for s, js in zip(sd["slow"], jsd["slow"]):
        _held(s, js, "slow")
    assert to.get_lr() == jo.get_lr()


def test_lookahead_loads_a_jax_state_dict():
    """The JAX state dict (numpy slow weights) set into the port; the
    next steps equal JAX's."""
    jm, tm = _mlp_pair()
    jo = jopt.LookAhead(INNER["sgd"][0](jm.parameters()), alpha=0.5, k=3)
    batches = _batches()
    for x, y in batches[:4]:
        _jax_step(jm, jo, x, y)
    params, _ = jm.functional_state()
    load_reference_state(tm, {n: np.asarray(v) for n, v in params.items()})
    to = topt.LookAhead(INNER["sgd"][1](list(tm.parameters())), alpha=0.5,
                        k=3)
    to.set_state_dict(jo.state_dict())
    assert to._steps == 4
    for x, y in batches[4:8]:
        _jax_step(jm, jo, x, y)
        _port_step(tm, to, x, y)
        _params_held(jm, tm, "resumed")


def test_lookahead_and_model_average_mirror_test_domains():
    """`tests/test_domains.py::test_incubate_lookahead_and_model_average`
    on the port: the loss falls, the state dict has the slow weights and
    6 steps; `apply` then `restore` gives the live weights back."""
    torch.manual_seed(0)
    lin = tnn.Linear(4, 1, device="cpu")
    opt = topt.LookAhead(topt_base.SGD(parameters=lin.parameters(),
                                       learning_rate=0.1), alpha=0.5, k=2)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(8, 4).astype(np.float32))
    y = torch.from_numpy(rs.randn(8, 1).astype(np.float32))
    losses = []
    for _ in range(6):
        loss = ((lin(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]
    sd = opt.state_dict()
    assert "slow" in sd and sd["steps"] == 6
    ma = topt.ModelAverage(0.15, parameters=lin.parameters(),
                           max_average_window=4)
    w_live = lin.weight.detach().clone()
    for _ in range(3):
        ma.step()
    ma.apply()
    torch.testing.assert_close(lin.weight.detach(), w_live, rtol=1e-5,
                               atol=0)
    with torch.no_grad():
        lin.weight.mul_(0)
    ma.restore()
    assert torch.equal(lin.weight.detach(), w_live)
    fl = topt.DistributedFusedLamb(parameters=lin.parameters())
    loss = ((lin(x) - y) ** 2).mean()
    loss.backward()
    fl.step()
    fl.clear_grad()
    assert torch.isfinite(lin.weight).all()


@pytest.mark.parametrize("window", [4, 10000])
def test_model_average_matches_jax_over_12_steps(window):
    jm, tm = _mlp_pair()
    jsgd, tsgd = INNER["sgd"][0](jm.parameters()), \
        INNER["sgd"][1](list(tm.parameters()))
    jma = jopt.ModelAverage(0.15, parameters=jm.parameters(),
                            max_average_window=window)
    tma = topt.ModelAverage(0.15, parameters=list(tm.parameters()),
                            max_average_window=window)
    for x, y in _batches():
        _jax_step(jm, jsgd, x, y)
        _port_step(tm, tsgd, x, y)
        jma.step()
        tma.step()
    assert tma._count == jma._count == min(window, STEPS)
    live = [p.detach().clone() for p in tm.parameters()]
    jma.apply()
    tma.apply()
    _params_held(jm, tm, "averaged")
    tma.restore()
    jma.restore()
    assert all(torch.equal(p, q) for p, q in zip(tm.parameters(), live))
    _params_held(jm, tm, "restored")


def test_model_average_sums_in_the_parameter_dtype():
    """bf16 parameters are summed in bf16, as JAX's `zeros_like` sums do:
    the sums and the averages against JAX's over the same values."""
    rs = np.random.RandomState(2)
    vals = [rs.randn(16, 8).astype(np.float32) for _ in range(7)]
    import jax.numpy as jnp

    jp = P.to_tensor(vals[0])
    jp._value = jnp.asarray(vals[0], jnp.bfloat16)
    tp = torch.nn.Parameter(torch.from_numpy(vals[0]).bfloat16())
    jma = jopt.ModelAverage(0.15, parameters=[jp], max_average_window=5)
    tma = topt.ModelAverage(0.15, parameters=[tp], max_average_window=5)
    assert tma._sum[0].dtype == torch.bfloat16
    for v in vals:
        jp._value = jnp.asarray(v, jnp.bfloat16)
        with torch.no_grad():
            tp.copy_(torch.from_numpy(v))
        jma.step()
        tma.step()
    want = np.asarray(jnp.asarray(jma._sum[0], jnp.float32))
    assert np.array_equal(tma._sum[0].float().numpy(), want)
    jma.apply()
    tma.apply()
    assert np.array_equal(tp.detach().float().numpy(),
                          np.asarray(jnp.asarray(jp._value, jnp.float32)))


def test_distributed_fused_lamb_matches_jax_over_12_steps():
    jm, tm = _mlp_pair()
    excl = lambda p: len(p.shape) == 1
    jo = jopt.DistributedFusedLamb(
        learning_rate=0.01, lamb_weight_decay=0.05,
        parameters=jm.parameters(), exclude_from_weight_decay_fn=excl,
        clip_after_allreduce=False, alignment=64)
    to = topt.DistributedFusedLamb(
        learning_rate=0.01, lamb_weight_decay=0.05,
        parameters=list(tm.parameters()), exclude_from_weight_decay_fn=excl,
        clip_after_allreduce=False, alignment=64)
    assert isinstance(to, topt_base.Lamb)
    for i, (x, y) in enumerate(_batches()):
        _jax_step(jm, jo, x, y)
        _port_step(tm, to, x, y)
        _params_held(jm, tm, f"step {i}")


# ------------------------------------------------------------------- ASP
def test_asp_mask_and_density():
    """`tests/test_quant_asp.py::test_asp_mask_and_density` on the port,
    and the mask bit for bit JAX's."""
    w = np.random.RandomState(2).randn(8, 8).astype(np.float32)
    mask = tasp.create_mask(torch.from_numpy(w), n=2, m=4)
    assert np.array_equal(mask.numpy(),
                          jasp.create_mask(P.to_tensor(w), n=2,
                                           m=4).numpy())
    masked = torch.from_numpy(w) * mask
    assert tasp.check_sparsity(masked, n=2, m=4)
    assert abs(tasp.calculate_density(masked) - 0.5) < 1e-6
    assert not tasp.check_sparsity(torch.from_numpy(w), n=2, m=4)


@pytest.mark.parametrize("shape,n,m", [((16, 32), 2, 4), ((3, 4, 24), 1, 4),
                                        ((12, 16), 4, 8)])
def test_asp_create_mask_matches_jax(shape, n, m):
    w = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = jasp.create_mask(P.to_tensor(w), n=n, m=m).numpy()
    got = tasp.create_mask(torch.from_numpy(w), n=n, m=m)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert tasp.check_sparsity(w * want, n=n, m=m) == \
        jasp.check_sparsity(w * want, n=n, m=m) is True
    bf = tasp.create_mask(torch.from_numpy(w).bfloat16(), n=n, m=m)
    assert bf.dtype == torch.bfloat16


def test_asp_refusals_match_jax():
    w = np.ones((4, 6), np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        jasp.create_mask(P.to_tensor(w))
    with pytest.raises(ValueError, match="not divisible"):
        tasp.create_mask(torch.from_numpy(w))
    assert tasp.check_sparsity(w) is jasp.check_sparsity(w) is False


def test_asp_prune_model_and_decorate_match_jax():
    """`tests/test_quant_asp.py::test_asp_prune_model_and_decorate` on
    both packages from the same weights: the pruned weights equal, and 3
    decorated SGD steps keep 2:4 sparsity and equal JAX's parameters."""
    jm, tm = _mlp_pair(seed=4, dims=(8, 8, 4))
    jasp.reset_excluded_layers()
    tasp.reset_excluded_layers()
    jasp.prune_model(jm, n=2, m=4)
    pruned = tasp.prune_model(tm, n=2, m=4)
    assert len(pruned) == 2 and len(tasp._masks) == 2
    _params_held(jm, tm, "pruned")
    assert tasp.check_sparsity(tm[0].weight, n=2, m=4)
    jo = jasp.decorate(P.optimizer.SGD(0.1, parameters=jm.parameters()))
    to = tasp.decorate(topt_base.SGD(0.1, parameters=list(tm.parameters())))
    rs = np.random.RandomState(3)
    for _ in range(3):
        x = rs.rand(4, 8).astype(np.float32)
        lj = (jm(P.to_tensor(x)) ** 2).mean()
        lj.backward()
        jo.step()
        jo.clear_grad()
        lt = (tm(torch.from_numpy(x)) ** 2).mean()
        lt.backward()
        to.step()
        to.clear_grad()
        assert tasp.check_sparsity(tm[0].weight, n=2, m=4)
        assert tasp.check_sparsity(tm[2].weight, n=2, m=4)
        _params_held(jm, tm, "decorated step")
    jasp.reset_excluded_layers()
    tasp.reset_excluded_layers()


def test_asp_excluded_layers_and_reset():
    _, tm = _mlp_pair(seed=5, dims=(8, 8, 4))
    tasp.reset_excluded_layers()
    tasp.prune_model(tm)
    assert id(tm[0].weight) in tasp._masks
    tasp.set_excluded_layers(tm, ["0"])
    assert id(tm[0].weight) not in tasp._masks
    assert id(tm[2].weight) in tasp._masks
    tasp.reset_excluded_layers()
    assert not tasp._masks
    pruned = tasp.prune_model(tm, with_mask=False)
    assert len(pruned) == 2 and not tasp._masks
    # JAX's rule reads the last dim: a 4x4 conv is prunable, a 3x3 conv
    # and a 6-wide linear are not
    m = tnn.Sequential(tnn.Conv2D(3, 8, 4, device="cpu"),
                       tnn.Conv2D(8, 8, 3, device="cpu"),
                       tnn.Linear(8, 6, device="cpu"))
    assert [tuple(w.shape) for w in tasp._prunable_params(m)] == \
        [(8, 3, 4, 4)]
