"""`jit.to_static` in training (``paddle_tpu_torch/jit/api.py``:
`_TrainProgram`, `_Replayed`) on the CPU.

On the CPU a `StaticFunction` runs its function eagerly, so its loss and
gradients equal the eager model's bit for bit; they are held against
the JAX package's `to_static` in training (one compiled program on the
tape) within 1e-4 of the largest gradient.  The card path (a forward and
a backward CUDA graph per signature, replay == eager bit for bit) runs
here through the stand-in graph of ``tests/test_torch_graphs.py``
(`_BodyGraph`, whose replay runs the captured body): the first call of a
signature runs eagerly and captures both graphs, later calls replay
them; the parameters' gradients accumulate over calls exactly as the
eager model's do (bit for bit); a backward after the next forward of the
same signature raises; a capture that fails raises and nothing runs
eagerly instead; a rebound parameter (`amp.decorate`, ``.to()``)
captures again; a function of tensors that require grad gets their
gradients back.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch.core import graphs as GR
from paddle_tpu_torch.jit import api as TJA
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import load_reference_state
from test_torch_graphs import _BodyGraph, _cpu_replay

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores
torch.set_num_threads(1)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=16, fused_head_ce=True)
CUDA = torch.device("cuda", 0)


def _pair(seed=0, fused=True):
    cfg = dict(CFG, fused_head_ce=fused)
    P.seed(seed)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**cfg))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu")
    load_reference_state(tm, {n: np.asarray(x) for n, x in
                              jm.functional_state()[0].items()})
    return jm, tm.train()


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randint(0, 128, (2, 16)).astype(np.int32)),
            torch.from_numpy(rs.randint(0, 128, (2, 16)).astype(np.int32)))


def _grads(model):
    return [None if p.grad is None else p.grad.clone()
            for p in model.parameters()]


def test_to_static_training_on_cpu_equals_eager_and_jax():
    """With the logits head (the JAX `to_static` program does not carry
    the fused head's hidden-state marker to its criterion)."""
    jm, tm = _pair(fused=False)
    _, eager = _pair(fused=False)
    ids, labels = _batch(1)
    assert TJ.to_static(tm) is tm
    crit = TG.GPTPretrainingCriterion(fused=False)
    loss = crit(tm(ids), labels)
    loss.backward()
    eloss = crit(eager(ids), labels)
    eloss.backward()
    assert torch.equal(loss, eloss)
    for a, b in zip(_grads(tm), _grads(eager)):
        assert torch.equal(a, b)
    jm.train()
    P.jit.to_static(jm)
    jloss = JG.GPTPretrainingCriterion(fused=False)(
        jm(P.to_tensor(ids.numpy(), "int32")),
        P.to_tensor(labels.numpy(), "int32"))
    jloss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), rtol=1e-5)
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        ref = jg[n]
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * max(1e-6, np.abs(ref).max()), (n, err)


def _stand_in(monkeypatch):
    _cpu_replay(monkeypatch)
    cpu_generator = TJA.rng.generator
    monkeypatch.setattr(TJA.rng, "generator",
                        lambda device: cpu_generator("cpu"))


def _train_call(sf, model, batch):
    """One training call through the replay path; its loss, backward
    run."""
    ids, labels = batch
    out = sf._replay((ids,), {}, CUDA)
    loss = TG.GPTPretrainingCriterion(model=model)(out, labels)
    loss.backward()
    return loss.detach()


def test_replay_path_captures_once_and_accumulates_like_eager(monkeypatch):
    """Three micro-batches, each forward then backward, gradients
    accumulated: the first call runs eagerly and captures the forward
    and the backward graph, the next two replay them; losses and
    accumulated gradients equal the eager model's bit for bit."""
    _stand_in(monkeypatch)
    _, tm = _pair()
    _, eager = _pair()
    sf = TJA.StaticFunction(tm)
    batches = [_batch(s) for s in (2, 3, 4)]
    got = torch.stack([_train_call(sf, tm, b) for b in batches])
    want = []
    for ids, labels in batches:
        loss = TG.GPTPretrainingCriterion(model=eager)(eager(ids), labels)
        loss.backward()
        want.append(loss.detach())
    assert torch.equal(got, torch.stack(want))
    for (n, a), b in zip(tm.named_parameters(), eager.parameters()):
        assert torch.equal(a.grad, b.grad), n
    fwd, bwd = _BodyGraph.made
    assert (fwd.replays, bwd.replays) == (2, 2)
    assert fwd.generators and bwd.generators == ()
    assert (fwd.stream, fwd.pool) == (bwd.stream, bwd.pool) \
        == ("stream", "pool")


def test_backward_after_the_next_forward_raises(monkeypatch):
    _stand_in(monkeypatch)
    _, tm = _pair()
    sf = TJA.StaticFunction(tm)
    crit = TG.GPTPretrainingCriterion(model=tm)
    _train_call(sf, tm, _batch(5))                   # captures
    ids, labels = _batch(6)
    first = crit(sf._replay((ids,), {}, CUDA), labels)
    second = crit(sf._replay((ids,), {}, CUDA), labels)
    second.backward()
    with pytest.raises(RuntimeError, match="later call"):
        first.backward()


def test_failed_capture_raises_and_runs_nothing_eagerly(monkeypatch):
    _stand_in(monkeypatch)

    class Broken(_BodyGraph):
        def __init__(self, *a, **k):
            raise RuntimeError("capture failed")

    monkeypatch.setattr(GR, "Graph", Broken)
    _, tm = _pair()
    sf = TJA.StaticFunction(tm)
    with pytest.raises(RuntimeError, match="capture failed"):
        sf._replay((_batch(7)[0],), {}, CUDA)
    assert not sf._cache


def test_rebound_parameters_capture_again(monkeypatch):
    _stand_in(monkeypatch)
    _, tm = _pair()
    sf = TJA.StaticFunction(tm)
    _train_call(sf, tm, _batch(8))
    _train_call(sf, tm, _batch(9))
    assert len(_BodyGraph.made) == 2
    with torch.no_grad():
        tm.gpt.ln_f.weight.mul_(0.5)            # in place: kept
    _train_call(sf, tm, _batch(9))
    assert len(_BodyGraph.made) == 2
    tm.to(torch.float64).to(torch.float32)      # rebinds every parameter
    _train_call(sf, tm, _batch(9))
    assert len(_BodyGraph.made) == 4


def test_function_inputs_that_require_grad_get_gradients(monkeypatch):
    _stand_in(monkeypatch)

    @TJ.to_static
    def f(x, w):
        return (x @ w).tanh(), x.sum()

    rs = np.random.RandomState(10)
    for i in range(3):
        x = torch.from_numpy(rs.randn(3, 4).astype(np.float32))
        w = torch.from_numpy(rs.randn(4, 2).astype(np.float32))
        tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
        y, s = f._replay((tx, tw), {}, CUDA)
        (y.square().sum() + 2 * s).backward()
        ex, ew = x.clone().requires_grad_(), w.clone().requires_grad_()
        ((ex @ ew).tanh().square().sum() + 2 * ex.sum()).backward()
        assert torch.equal(tx.grad, ex.grad) and torch.equal(tw.grad, ew.grad)
    assert [g.replays for g in _BodyGraph.made] == [2, 2]
