"""The port's fixed-shape programs (``paddle_tpu_torch/core/graphs.py``),
on the CPU: what a CUDA graph of them captures and replays.

The engine's decode and prefill programs, the train step,
`generate()`'s decode chunks and `jit.to_static` run as CUDA graphs on
the card (held there bit for bit against their eager bodies by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  A graph replays
the reads and writes of its capture, so here:

  * the decode program's body reads only its static buffers: two
    batches copied into one program give the tokens and pools of two
    eager bodies on fresh tensors, and the engine's streams through the
    program equal the JAX engine's, exact and int8 tiers;
  * the optimizers keep their step count on the device and take the
    learning rate as a device tensor: AdamW, Adam and Momentum agree
    with the JAX `apply_gradients` within 1e-6, a plain int step is
    still accepted, and N updates agree with the host-scalar formula
    they replace within 1e-6;
  * the replay bookkeeping: a capture's kernel launches leave the
    counters as they were, and each replay adds them once;
  * the train step's replay path (with a stand-in graph that re-runs
    the captured body): losses equal the eager steps', `repeat` copies
    its batch once, and a rebound optimizer slot drops the graph, so no
    stale address is replayed;
  * the prefill programs (cold and warm, exact and int8 tiers), the
    decode-chunk program and `StaticFunction` replayed through the
    stand-in graph read only their static buffers: a second input
    copied into them gives what the eager body gives on fresh tensors
    (tokens exactly; the pools without scratch page 0, whose content
    is garbage by design);
  * the dense decode path, the warm prefill and `decode_position_ids`
    take a 0-dim device position and give the int path's bits;
  * every capture of a thread runs on one side stream per device;
  * rules: the capture and replay path holds no try/except and no CPU
    or eager branch, and nothing turns the graphs off.
"""
from __future__ import annotations

import ast
import contextlib
import inspect
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu.optimizer.optimizer import Adam as JAdam
from paddle_tpu.optimizer.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer.optimizer import Momentum as JMomentum
from paddle_tpu_torch.core import graphs as GR
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.distributed import train_step as TS
from paddle_tpu_torch.inference.engine import (
    EngineConfig, InferenceEngine,
)
from paddle_tpu_torch.inference.engine import engine as EN
from paddle_tpu_torch.jit import api as JA
from paddle_tpu_torch.models import generation as GEN
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import rope as RP
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
from test_torch_engine import models, prompts  # noqa: F401  (fixtures)
from test_torch_quant_kv import gpt  # noqa: F401  (fixture)


# ------------------------------------------------------ the decode program
def _two_batches(eng, n):
    s_, p_ = eng.config.max_slots, eng.max_pages_per_seq
    rs = np.random.RandomState(5)
    out = []
    for order in (1, -1):     # every slot on pages of its own
        pt = (1 + np.arange(s_ * p_, dtype=np.int32)).reshape(s_, p_)
        out.append((rs.randint(0, 128, s_).astype(np.int32),
                    np.ascontiguousarray(pt[::order]),
                    rs.randint(0, eng.config.max_seq_len - n,
                               s_).astype(np.int32)))
    return out


@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_decode_program_reads_only_its_buffers(request, prompts, tier):
    jm, tm = request.getfixturevalue("models" if tier == "exact"
                                     else "gpt")
    kv = None if tier == "exact" else "int8"
    cfg = dict(page_size=8, max_slots=3, decode_chunk=2, max_seq_len=64,
               kv_precision=kv)
    jouts = JEngine(jm, JEngineConfig(**cfg)).generate(prompts,
                                                       max_new_tokens=6)
    eng = InferenceEngine(tm, EngineConfig(**cfg))
    for o, j in zip(eng.generate(prompts, max_new_tokens=6), jouts):
        np.testing.assert_array_equal(o, j)
    assert list(eng._programs) == [(2, kv)]
    prog = eng._decode_program(2)
    pools = eng._pool_tensors()
    start = [p.clone() for p in pools]
    with torch.inference_mode():
        for tok, pt, lengths in _two_batches(eng, 2):
            for p, s in zip(pools, start):
                p.copy_(s)
            for dst, src in ((prog.tok, tok), (prog.pt, pt),
                             (prog.lengths, lengths)):
                dst.copy_(torch.from_numpy(src))
            # the call a capture records
            eng._decode_body(2, prog.tok, prog.pt, prog.lengths, prog.toks)
            got = prog.toks.clone()
            got_pools = [p.clone() for p in pools]
            for p, s in zip(pools, start):
                p.copy_(s)
            want = torch.zeros(3, 2, dtype=torch.int32)
            eng._decode_body(2, *(torch.from_numpy(a.copy())
                                  for a in (tok, pt, lengths)), want)
            assert torch.equal(got, want)
            assert all(torch.equal(a, b) for a, b in zip(got_pools, pools))
            # and through the engine's own entry
            for p, s in zip(pools, start):
                p.copy_(s)
            np.testing.assert_array_equal(
                eng._run_decode(2, tok, pt, lengths), want.numpy())


# ----------------------------------------- device step count and rate
def _update_inputs(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"w": (5, 7), "b": (7,)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    slots = {n: {"moment1": rs.randn(*s).astype(np.float32) * 0.1,
                 "moment2": rs.rand(*s).astype(np.float32) * 0.01,
                 "velocity": rs.randn(*s).astype(np.float32) * 0.1}
             for n, s in shapes.items()}
    return params, grads, slots


OPTS = {"adamw": (AdamW, JAdamW, ("moment1", "moment2")),
        "adam": (Adam, JAdam, ("moment1", "moment2")),
        "momentum": (Momentum, JMomentum, ("velocity",)),
        "nesterov": (Momentum, JMomentum, ("velocity",))}


def _kw(opt):
    kw = dict(learning_rate=3e-3, weight_decay=0.1)
    if opt == "nesterov":
        kw["use_nesterov"] = True
    return kw


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_device_step_and_rate_match_apply_gradients(opt):
    """One update at step 2 with the rate as a 0-dim tensor, against the
    JAX rule; the step tensor advances in place."""
    cls, jcls, keys = OPTS[opt]
    params, grads, slots = _update_inputs()
    jp, js = jcls(**_kw(opt)).apply_gradients(
        {n: jnp.asarray(x) for n, x in params.items()},
        {n: jnp.asarray(x) for n, x in grads.items()},
        {"slots": {n: {k: jnp.asarray(s[k]) for k in keys}
                   for n, s in slots.items()},
         "step": jnp.asarray(2, jnp.int32)})
    tp = {n: torch.from_numpy(x.copy()) for n, x in params.items()}
    step = torch.tensor(2, dtype=torch.int32)
    ts = {"slots": {n: {k: torch.from_numpy(s[k].copy()) for k in keys}
                    for n, s in slots.items()}, "step": step}
    cls(**_kw(opt)).apply_gradients(
        tp, {n: torch.from_numpy(x) for n, x in grads.items()}, ts,
        lr=torch.tensor(3e-3))
    assert ts["step"] is step and int(step) == int(js["step"]) == 3
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=1e-6)
        for k in keys:
            np.testing.assert_allclose(ts["slots"][n][k].numpy(),
                                       np.asarray(js["slots"][n][k]),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_int_step_and_float_rate_still_accepted(opt):
    cls, _, keys = OPTS[opt]
    params, grads, slots = _update_inputs(1)
    runs = []
    for step, lr in ((4, None), (torch.tensor(4, dtype=torch.int32),
                                 torch.tensor(3e-3))):
        tp = {n: torch.from_numpy(x.copy()) for n, x in params.items()}
        ts = {"slots": {n: {k: torch.from_numpy(s[k].copy()) for k in keys}
                        for n, s in slots.items()}, "step": step}
        cls(**_kw(opt)).apply_gradients(
            tp, {n: torch.from_numpy(x) for n, x in grads.items()}, ts,
            lr=lr)
        assert isinstance(ts["step"], torch.Tensor)
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 5
        runs.append(tp)
    for n in params:
        assert torch.equal(runs[0][n], runs[1][n])
    fresh = cls(**_kw(opt)).init_state({n: torch.zeros(2) for n in "ab"})
    assert fresh["step"].dtype == torch.int32 and int(fresh["step"]) == 0


def _host_scalar_update(opt, params, grads, slots, t, lr=3e-3, wd=0.1):
    """The rules as they computed with host scalars: the step a Python
    int, the bias corrections and the rate Python floats."""
    names = list(params)
    ps = [params[n] for n in names]
    gs = [grads[n] for n in names]
    if opt in ("momentum", "nesterov"):
        gs = torch._foreach_add(gs, ps, alpha=wd)
        v = [slots[n]["velocity"] for n in names]
        torch._foreach_mul_(v, 0.9)
        torch._foreach_add_(v, gs)
        step = torch._foreach_add(gs, v, alpha=0.9) if opt == "nesterov" \
            else v
        torch._foreach_add_(ps, step, alpha=-lr)
        return
    b1, b2 = 0.9, 0.999
    if opt == "adamw":
        torch._foreach_mul_(ps, 1.0 - lr * wd)
    else:
        gs = torch._foreach_add(gs, ps, alpha=wd)
    m = [slots[n]["moment1"] for n in names]
    v = [slots[n]["moment2"] for n in names]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, gs, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, gs, gs, value=1 - b2)
    denom = torch._foreach_sqrt(torch._foreach_div(v, 1 - b2 ** t))
    torch._foreach_add_(denom, 1e-8)
    torch._foreach_addcdiv_(ps, torch._foreach_div(m, 1 - b1 ** t), denom,
                            value=-lr)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_device_step_updates_match_the_host_scalar_formula(opt):
    """Six updates from step 0: the device-step rule against the
    host-scalar one, parameters and slots within 1e-6."""
    cls, _, keys = OPTS[opt]
    params, _, slots = _update_inputs(2)
    rs = np.random.RandomState(3)
    grads = [{n: torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
              for n, x in params.items()} for _ in range(6)]

    def copy():
        return ({n: torch.from_numpy(x.copy()) for n, x in params.items()},
                {n: {k: torch.from_numpy(s[k].copy()) for k in keys}
                 for n, s in slots.items()})

    tp, tslots = copy()
    hp, hslots = copy()
    opt_ = cls(**_kw(opt))
    state = {"slots": tslots, "step": opt_.init_state(tp)["step"]}
    lr = torch.tensor(3e-3)
    for t, g in enumerate(grads, 1):
        opt_.apply_gradients(tp, g, state, lr=lr)
        _host_scalar_update(opt, hp, g, hslots, t)
    assert int(state["step"]) == 6
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), hp[n].numpy(), atol=1e-6,
                                   rtol=1e-6)
        for k in keys:
            np.testing.assert_allclose(tslots[n][k].numpy(),
                                       hslots[n][k].numpy(), atol=1e-6,
                                       rtol=1e-6)


# -------------------------------------------------- the replay bookkeeping
class _FakeCUDAGraph:
    """Stands in for torch.cuda.CUDAGraph: counts replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeCapture:
    """Stands in for the torch.cuda.graph context manager."""

    def __init__(self, graph, pool=None, stream=None,
                 capture_error_mode=None):
        assert capture_error_mode == "thread_local"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_captured_launches_are_added_once_per_replay(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)
    K.reset_launches()
    PA.int8_launches = 5             # launches made before the capture

    def body():                       # what the wrappers count in a capture
        PA.launches += 2
        RP.launches += 1
        return "outputs"

    g = GR.Graph(body, stream=None)
    assert g.outputs == "outputs"
    assert g.launches == {"paged_attention": 2, "rope": 1}
    counts = K.launch_counts()
    assert counts["paged_attention"] == counts["rope"] == 0
    assert counts["paged_attention_int8"] == 5
    for r in range(1, 4):
        g.replay()
        counts = K.launch_counts()
        assert (counts["paged_attention"], counts["rope"]) == (2 * r, r)
        assert counts["paged_attention_int8"] == 5
    assert g.graph.replays == 3
    K.reset_launches()


def test_programs_hold_no_reference_cycle(monkeypatch, models):
    """A graph keeps no reference to the body it captured, and an
    engine's decode programs none to the engine: a dropped engine (or
    train step) frees its pools and graphs by reference counting, not at
    the next garbage collection."""
    import functools
    import gc
    import weakref

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)
    _, tm = models
    gc.disable()
    try:
        eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                               max_seq_len=64))
        eng.generate([np.arange(5, dtype=np.int32)], max_new_tokens=3)
        assert eng._programs
        pool = weakref.ref(eng._k_pools[0])
        prog = eng._decode_program(1)
        with torch.inference_mode():     # as the engine captures
            g = GR.Graph(functools.partial(eng._decode_body, 1, prog.tok,
                                           prog.pt, prog.lengths, prog.toks),
                         stream=None)
        del eng
        assert pool() is None
        assert g.outputs is not None and g.graph.replays == 0
    finally:
        gc.enable()
    K.reset_launches()


# ------------------------------------------- the train step's replay path
class _BodyGraph:
    """Stands in for `GR.Graph` on the CPU: the capture runs nothing, a
    replay runs the captured body and keeps its result as `outputs`."""

    made = []

    def __init__(self, body, stream, pool=None, generators=()):
        self.body, self.outputs, self.replays = body, torch.zeros(()), 0
        self.stream, self.pool, self.generators = stream, pool, generators
        _BodyGraph.made.append(self)

    def replay(self):
        self.replays += 1
        self.outputs = self.body()


def _cpu_replay(monkeypatch):
    _BodyGraph.made = []
    monkeypatch.setattr(GR, "Graph", _BodyGraph)
    monkeypatch.setattr(GR, "warm_up", lambda body, stream: body())
    monkeypatch.setattr(GR, "capture_stream", lambda device: "stream")
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")


def _tiny_step(seed=4):
    cfg = TG.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                       num_heads=2, max_seq_len=16, fused_head_ce=True)
    tm = TG.GPTForCausalLM(cfg, device="cpu", seed=seed)
    return build_train_step(tm, AdamW(learning_rate=1e-3),
                            TG.GPTPretrainingCriterion(model=tm))


def test_train_step_replay_path_reads_its_static_batch(monkeypatch):
    """Three distinct batches, then one batch three times: the first
    step runs the body and captures, the rest replay the one graph; the
    losses and parameters equal plain eager steps, and `repeat` copies
    its batch into the static buffers once."""
    _cpu_replay(monkeypatch)
    rs = np.random.RandomState(6)
    ids = rs.randint(0, 64, (3, 2, 16)).astype(np.int32)
    labels = rs.randint(0, 64, (3, 2, 16)).astype(np.int32)
    steps = [_tiny_step(), _tiny_step()]
    eager = torch.cat([steps[0].run_steps(ids, labels),
                       steps[0].run_steps(ids[0], labels[0], repeat=3)])
    placed = steps[1]._place((ids, labels))
    copies = []
    real_copy = torch.Tensor.copy_
    monkeypatch.setattr(torch.Tensor, "copy_", lambda t, s, *a, **k: (
        copies.append(t.shape), real_copy(t, s, *a, **k))[1])
    first = steps[1]._replay([tuple(b[i] for b in placed)
                              for i in range(3)], [1e-3] * 3)
    copies.clear()
    one = steps[1]._place((ids[0], labels[0]))
    again = steps[1]._replay([one] * 3, [1e-3] * 3)
    batch_copies = [c for c in copies if c == (2, 16)]
    assert len(batch_copies) == 2    # ids and labels, once
    monkeypatch.undo()
    assert torch.equal(torch.cat([first, again]), eager)
    assert len(_BodyGraph.made) == 1 and _BodyGraph.made[0].replays == 5
    for a, b in zip(steps[0].model.parameters(),
                    steps[1].model.parameters()):
        assert torch.equal(a, b)


def test_train_step_drops_its_graph_when_state_is_rebound(monkeypatch):
    """A graph holds the addresses it captured: a slot copied in place
    keeps the graph, a slot rebound (or the step reset to an int) drops
    it, so the next step runs the body and captures again; every loss
    equals a plain eager run's."""
    _cpu_replay(monkeypatch)
    rs = np.random.RandomState(7)
    batch = [rs.randint(0, 64, (2, 16)).astype(np.int32) for _ in range(2)]
    eager, graphed = _tiny_step(), _tiny_step()
    placed = graphed._place(batch)

    def both(edit):
        for s in (eager, graphed):
            edit(s)
        want = eager.run_steps(*batch, repeat=2)
        return want, graphed._replay([placed, placed], [1e-3] * 2)

    def slot(s):
        return s._state["slots"]["gpt.wte.weight"]

    def scale(s):
        with torch.no_grad():
            slot(s)["moment1"].mul_(0.5)

    def rebind(s):
        slot(s)["moment1"] = slot(s)["moment1"] * 0.5

    def reset_step(s):
        s._state["step"] = 3

    for edit, captures in ((lambda s: None, 1), (scale, 1), (rebind, 2),
                           (reset_step, 3)):
        before = {id(g): g.replays for g in _BodyGraph.made}
        want, got = both(edit)
        assert torch.equal(got, want)
        assert len(_BodyGraph.made) == captures
        (current,) = [g for _, g in graphed._graphs.values()]
        # a dropped graph is never replayed again
        assert all(g.replays == before[id(g)] for g in _BodyGraph.made
                   if g is not current)
    assert int(graphed._state["step"]) == int(eager._state["step"]) == 5


# ----------------------------------------------- device positions
def _rand(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32))


def test_device_position_gives_the_int_paths_bits():
    """`_static_cache_attention` (the dense decode write and read, the
    warm prefill) and `decode_position_ids` with cache_pos a 0-dim int32
    tensor equal the int path bit for bit (f32, GQA 4/2); the warm
    prefill's hidden prefix rows do not reach its output."""
    rs = np.random.RandomState(11)
    b, hq, hkv, d, cap = 3, 4, 2, 8, 32
    start = torch.tensor([0, 2, 5], dtype=torch.int32)
    caches = (_rand(rs, b, hkv, cap, d), _rand(rs, b, hkv, cap, d))

    def run(s, pos, kv=caches, guard=None):
        q = _rand(np.random.RandomState(s), b, s, hq, d)
        k = _rand(np.random.RandomState(s + 1), b, s, hkv, d)
        v = _rand(np.random.RandomState(s + 2), b, s, hkv, d)
        kv = tuple(c.clone() for c in kv)
        with GEN.warm_prefill_guard(guard) if guard else \
                contextlib.nullcontext():
            out, kv = GEN._static_cache_attention(q, k, v, kv, pos, start)
        return out, kv

    for s, p, guard in ((1, 9, None), (6, 12, 16)):
        host = run(s, p, guard=guard)
        dev = run(s, torch.tensor(p, dtype=torch.int32), guard=guard)
        assert torch.equal(host[0], dev[0])
        assert all(torch.equal(x, y) for x, y in zip(host[1], dev[1]))
    # the warm prefill: rows [12, 16) are hidden keys
    other = tuple(c.clone() for c in caches)
    for c in other:
        c[:, :, 12:16] = 1e3
    hidden = run(6, torch.tensor(12, dtype=torch.int32), other, 16)
    assert torch.equal(hidden[0], dev[0])
    for s in (1, 5):
        want = GEN.decode_position_ids(7, b, s, start)
        got = GEN.decode_position_ids(torch.tensor(7, dtype=torch.int32), b,
                                      s, start)
        assert torch.equal(want, got) and want.dtype == got.dtype


# ------------------------------------------------ the prefill programs
def _prefill_inputs(prompt, sb):
    start = sb - prompt.size
    ids = np.zeros((1, sb), np.int32)
    ids[0, start:] = prompt
    return ids, start


@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_prefill_programs_read_only_their_buffers(monkeypatch, request,
                                                  prompts, tier):
    """A cold and a warm prefill program captured with the stand-in graph
    (the warm-up on zero buffers first), then replayed on two inputs
    each: the first token, the pools without scratch page 0 and the
    staging buffers equal the eager prefill and pack on the same inputs
    (`_run_prefill` / `_run_cached_prefill`, `_run_pack`), exactly."""
    jm, tm = request.getfixturevalue("models" if tier == "exact"
                                     else "gpt")
    kv = None if tier == "exact" else "int8"
    eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                           max_seq_len=64, kv_precision=kv))
    _cpu_replay(monkeypatch)
    n_pools = len(eng._pool_tensors())
    state = eng._prefill_tensors()
    rs = np.random.RandomState(12)
    with torch.inference_mode():
        for t in state:       # every page and staging row distinct
            t.copy_(torch.from_numpy(rs.randn(*t.shape) * 3).to(t.dtype))
        start_state = [t.clone() for t in state]
        cold = EN._PrefillProgram(16, None, 4, tier == "exact", eng._device)
        warm = EN._PrefillProgram(8, 4, 2, tier == "exact", eng._device)
        for prog in (cold, warm):
            eng._capture_prefill(prog)
        assert all(torch.equal(a[1:], b[1:]) for a, b in
                   zip(state[:n_pools], start_state[:n_pools]))
        cases = [(cold, prompts[1], [3, 5, 7, 0], 0),
                 (cold, prompts[4], [2, 4, 6, 0], 0),
                 (warm, prompts[0], [9, 0], 16),
                 (warm, prompts[3], [8, 10], 12)]
        for prog, prompt, pages, plen in cases:
            sb, npp = prog.sb, prog.npp
            ids, start = _prefill_inputs(prompt, sb)
            pages = np.array(pages, np.int32)
            prefix = None if npp is None else np.array(
                [11, 12, 13, 14][:plen // 4] + [0] * (npp - plen // 4),
                np.int32)
            for t, s0 in zip(state, start_state):
                t.copy_(s0)
            eng._load_prefill(prog, ids, start, pages, plen,
                              prefix if kv is None else None)
            eng._replay_prefill(prog)
            got_tok, got = int(prog.tok[0]), [t.clone() for t in state]
            for t, s0 in zip(state, start_state):
                t.copy_(s0)
            if npp is None:
                tok, kb, vb = eng._run_prefill(sb, ids, start)
                offset = start
            else:
                pg = torch.from_numpy(prefix).long()
                pk = [st[:npp].clone() for st in eng._stage_k] if kv else \
                    [pool[pg] for pool in eng._k_pools]
                pv = [st[:npp].clone() for st in eng._stage_v] if kv else \
                    [pool[pg] for pool in eng._v_pools]
                tok, kb, vb = eng._run_cached_prefill(sb, npp, ids, start,
                                                      plen, pk, pv)
                offset = npp * 4 + start
            eng._run_pack(kb, vb, pages, offset)
            assert got_tok == tok
            for i, (a, b) in enumerate(zip(got, state)):
                # scratch page 0 of a pool: garbage by design
                assert torch.equal(a[1:], b[1:]) if i < n_pools \
                    else torch.equal(a, b)
    assert len(_BodyGraph.made) == 2
    assert [g.replays for g in _BodyGraph.made] == [2, 2]


@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_engine_streams_through_the_prefill_replay_path(monkeypatch, request,
                                                        prompts, tier):
    """The engine's prefills through the CUDA path with the stand-in
    graph: each program's first prefill runs its body before the capture
    (a real prefill, after its inputs and the int8 sidecar's prefix are
    loaded), later ones replay.  Two runs of the prompts (warm prefills
    included) give the CPU path's streams exactly, and the first its
    pools too (scratch page 0 left out; the second run's pages come off
    a free list in another order)."""
    _, tm = request.getfixturevalue("models" if tier == "exact" else "gpt")
    cfg = EngineConfig(page_size=4, max_slots=2, max_seq_len=64,
                       kv_precision=None if tier == "exact" else "int8")
    ref = InferenceEngine(tm, cfg)
    want = ref.generate(prompts, max_new_tokens=6)
    _cpu_replay(monkeypatch)
    eng = InferenceEngine(tm, cfg)

    def cuda_path(prog, ids, start, pages, plen=0, prefix_pages=None):
        # `_run_prefill_program`'s branch for a device other than the CPU
        eng._load_prefill(prog, ids, start, pages, plen, prefix_pages)
        eng._replay_prefill(prog)
        return int(prog.tok[0])

    eng._run_prefill_program = cuda_path
    for run in range(2):
        for g, w in zip(eng.generate(prompts, max_new_tokens=6), want):
            np.testing.assert_array_equal(g, w)
        if run == 0:
            for a, b in zip(eng._pool_tensors(), ref._pool_tensors()):
                assert torch.equal(a[1:], b[1:])
        eng.clear_prefix_cache()
    assert eng.prefix_cache_stats()["hits"] >= 2
    progs = list(eng._prefills.values())
    assert any(p.npp for p in progs) and len(_BodyGraph.made) == len(progs)
    assert all(g.replays >= 1 for g in _BodyGraph.made)


def test_int8_commit_clones_the_staging_buffers(gpt, prompts):
    """The int8 tier's exact sidecar is a copy: the next prefill rewrites
    the staging buffers and leaves the committed pages as they were."""
    _, tm = gpt
    eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=1,
                                           max_seq_len=64,
                                           kv_precision="int8"))
    eng.generate([prompts[5]], max_new_tokens=2)
    nodes = list(eng._prefix._children.values())
    kept = [[(k.clone(), v.clone()) for k, v in n.exact] for n in nodes]
    eng.generate([prompts[2]], max_new_tokens=2)
    stage = eng._stage_k[0].untyped_storage().data_ptr()
    for node, was in zip(nodes, kept):
        for (k, v), (k0, v0) in zip(node.exact, was):
            assert torch.equal(k, k0) and torch.equal(v, v0)
            assert k.untyped_storage().data_ptr() != stage


# --------------------------------------------- generate()'s decode chunk
@pytest.mark.parametrize("eos", [False, True])
def test_decode_chunk_replay_reads_only_its_buffers(monkeypatch, models,
                                                    eos):
    """Two chunks of 4 steps of one program key through the stand-in
    graph: the first is the warm-up's real run and the capture, the
    second a replay; the tokens equal `generate()` on the CPU path (the
    eager body), whose stream equals the per-token loop's
    (`test_torch_gpt.py`); with eos a row finishes mid-chunk."""
    _, tm = models
    ids = np.random.RandomState(13).randint(0, 128, (2, 5)).astype(np.int32)
    full = tm.generate(ids, max_new_tokens=9)
    e = int(full[0, 5 + 3]) if eos else None
    want = tm.generate(ids, max_new_tokens=9, eos_token_id=e)
    _cpu_replay(monkeypatch)
    with torch.inference_mode():
        st = tm._chunk_state(GEN._generation(tm), 2, 14)
        logits, _ = tm(torch.from_numpy(ids), kv_caches=st.caches,
                       cache_pos=0)
        tok = logits[:, -1].float().argmax(-1).to(torch.int32)
        st.tok.copy_(tok)
        st.finished.copy_(tok == e if eos else torch.zeros_like(st.finished))
        out = [tok[:, None]]
        prog = st.programs.setdefault((4, False, e),
                                      GEN._ChunkProgram(2, 4, "cpu"))
        for i in (1, 5):
            st.pos0.fill_(5 + i - 1)
            tm._replay_chunk(st, prog, False, e)
            out.append(prog.toks.clone())
    got = torch.cat([torch.from_numpy(ids)] + out, dim=1)
    assert torch.equal(got[:, :want.shape[1]], want)
    assert len(_BodyGraph.made) == 1 and _BodyGraph.made[0].replays == 1


# ------------------------------------------------------ StaticFunction
def test_static_function_replay_reads_only_its_buffers(monkeypatch):
    """`StaticFunction._replay` through the stand-in graph: each call's
    input is copied into the signature's static input, the replay equals
    the eager forward bit for bit and is a clone; a rebound parameter
    captures again; a new signature captures its own graph on the same
    stream and pool."""
    from paddle_tpu_torch.vision import models as TV

    _cpu_replay(monkeypatch)
    model = TV.resnet18(num_classes=10, device="cpu")
    sf = JA.StaticFunction(model)
    rs = np.random.RandomState(14)
    xs = [torch.from_numpy(rs.randn(2, 3, 32, 32).astype(np.float32))
          for _ in range(3)]
    cuda = torch.device("cuda", 0)
    with torch.no_grad():
        for x in xs[:2]:
            got = sf._replay((x,), {}, cuda)
            assert torch.equal(got, model(x))
            assert got is not _BodyGraph.made[0].outputs
        assert len(_BodyGraph.made) == 1 and _BodyGraph.made[0].replays == 2
        model.fc.weight = torch.nn.Parameter(model.fc.weight * 0.5)
        assert torch.equal(sf._replay((xs[0],), {}, cuda), model(xs[0]))
        assert len(_BodyGraph.made) == 2
        x3 = xs[2][:1]
        assert torch.equal(sf._replay((x3,), {}, cuda), model(x3))
    first, _, third = _BodyGraph.made
    assert (first.stream, first.pool) == (third.stream, third.pool) \
        == ("stream", "pool")


# ------------------------------------------------------ capture stream
def test_one_capture_stream_per_device_and_thread(monkeypatch, models):
    """`capture_stream` makes one stream per (device, thread); the
    engine's two prefill captures on one thread share it and the
    engine's memory pool."""
    made = []

    def stream(index):
        made.append(index)
        return object()

    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(GR, "_THREAD", threading.local())
    a = GR.capture_stream("cuda")
    assert GR.capture_stream(torch.device("cuda", 0)) is a
    assert GR.capture_stream("cuda:1") is not a
    other = []
    th = threading.Thread(
        target=lambda: other.append(GR.capture_stream("cuda:0")))
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and other[0] is not a
    assert made == [0, 1, 0]
    _BodyGraph.made = []
    monkeypatch.setattr(GR, "Graph", _BodyGraph)
    monkeypatch.setattr(GR, "warm_up", lambda body, stream: body())
    pools = iter(["pool", "another"])
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(pools))
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(page_size=4, max_slots=2,
                                           max_seq_len=64))
    with torch.inference_mode():
        for sb in (8, 16):
            eng._capture_prefill(EN._PrefillProgram(sb, None, sb // 4, True,
                                                    eng._device))
    g1, g2 = _BodyGraph.made
    assert g1.stream is g2.stream is GR.capture_stream("cpu")
    assert g1.pool == g2.pool == "pool"


# ------------------------------------------------------------------ rules
def _tree(fn):
    return ast.parse(textwrap.dedent(inspect.getsource(fn)))


def _mentions_cpu_or_env(tree):
    text = ast.unparse(tree)
    return "cpu" in text or "environ" in text or "getenv" in text


def test_capture_and_replay_path_never_falls_back():
    """The CUDA path: `core.graphs`, `jit.api`, the engine's decode and
    prefill captures and replays, the train step's replay, `generate()`'s
    chunk replay and `StaticFunction`'s replay hold no try/except, test
    no device and read no environment; each entry branches once, a CPU
    device to the body, everything else to the replay; every capture
    runs on `capture_stream` (the engine's, `generate()`'s and
    `StaticFunction`'s in their owner's shared pool); no constructor can
    turn graphs off."""
    GM = GEN.GenerationMixin
    SF = JA.StaticFunction
    from paddle_tpu_torch.observability import capture_cost as CC

    for module in (GR, JA, CC):
        mod = ast.parse(inspect.getsource(module))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(mod))
        assert "environ" not in inspect.getsource(module)
    makers = (InferenceEngine._decode_program,
                InferenceEngine._prefill_program)
    for fn in (GR.warm_up, GR.capture, GR.Graph.__init__, GR.Graph.replay,
               GR.capture_stream, *makers,
               InferenceEngine._capture_decode,
               InferenceEngine._replay_decode,
               InferenceEngine._capture_prefill,
               InferenceEngine._replay_prefill,
               TS.DistributedTrainStep._replay, GM._replay_chunk,
               SF._replay):
        tree = _tree(fn)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn
        if fn not in makers:
            assert not _mentions_cpu_or_env(tree), fn
    # the functions that make the programs never run a body themselves;
    # a capture reaches its body only through the partial it records
    for fn in makers:
        assert "_body" not in ast.unparse(_tree(fn)), fn
    for fn, body in ((InferenceEngine._capture_decode, "self._decode_body"),
                     (InferenceEngine._capture_prefill, "self._prefill_body"),
                     (TS.DistributedTrainStep._replay, "self._step"),
                     (GM._replay_chunk, "self._decode_chunk_body"),
                     (SF._replay, "self._fn")):
        tree = _tree(fn)
        partials = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and ast.unparse(n.func) == "functools.partial"]
        assert len(partials) == 1, fn
        assert ast.unparse(partials[0].args[0]) == body, fn
        assert ast.unparse(tree).count(body) == 1, fn
        text = ast.unparse(tree)
        assert "GR.capture_stream(" in text and "torch.cuda.Stream" not in \
            text, fn
        # one capture, through `GR.capture` (warm-up and graph, timed
        # under the program's label)
        graphs = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                  and ast.unparse(n.func) in ("GR.Graph", "GR.capture",
                                              "GR.warm_up")]
        assert len(graphs) == 1, fn
        assert ast.unparse(graphs[0].func) == "GR.capture", fn
        assert len(graphs[0].args) == 3, fn           # body, stream, label
        if fn is not TS.DistributedTrainStep._replay:
            assert "pool" in [k.arg for k in graphs[0].keywords], fn
    for module in (EN, TS, GEN, JA):
        assert "torch.cuda.Stream" not in inspect.getsource(module), module
    for fn, test, body, replayed in (
            (InferenceEngine._run_decode, "self._device.type == 'cpu'",
             "self._decode_body", "self._replay_decode"),
            (InferenceEngine._run_prefill_program,
             "self._device.type == 'cpu'", "self._prefill_body",
             "self._replay_prefill"),
            (TS.DistributedTrainStep._run, "self._device.type == 'cpu'",
             "self._step", "self._replay"),
            (GM._run_decode_chunk, "self.device.type == 'cpu'",
             "self._decode_chunk_body", "self._replay_chunk"),
            (SF.__call__, "device.type == 'cpu'", "self._fn",
             "self._replay")):
        tree = _tree(fn)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
        ifs = [n for n in ast.walk(tree) if isinstance(n, ast.If)]
        assert len(ifs) == 1, fn
        assert ast.unparse(ifs[0].test) == test, fn
        cpu_side = ast.unparse(ast.Module(ifs[0].body, []))
        rest = ast.unparse(tree).replace(cpu_side, "")
        assert body in cpu_side and body not in rest, fn
        assert replayed in rest and replayed not in cpu_side, fn
    for ctor in (EngineConfig.__init__, InferenceEngine.__init__,
                 TS.DistributedTrainStep.__init__, build_train_step,
                 GM.generate, SF.__init__, JA.to_static):
        names = list(inspect.signature(ctor).parameters)
        assert not any("graph" in n or "eager" in n for n in names), ctor
    assert EN.GR is GR and TS.GR is GR and GEN.GR is GR and JA.GR is GR
