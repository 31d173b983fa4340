"""The port's fixed-shape programs (``paddle_tpu_torch/core/graphs.py``),
on the CPU: what a CUDA graph of them captures and replays.

The engine's decode program and the train step run as CUDA graphs on
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
  * rules: the capture and replay path holds no try/except and no CPU
    or eager branch, and nothing turns the graphs off.
"""
from __future__ import annotations

import ast
import inspect
import textwrap

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

    def __init__(self, graph, stream=None, capture_error_mode=None):
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
    replay runs the captured body and writes its result to `outputs`."""

    made = []

    def __init__(self, body, stream):
        self.body, self.outputs, self.replays = body, torch.zeros(()), 0
        _BodyGraph.made.append(self)

    def replay(self):
        self.replays += 1
        self.outputs.copy_(self.body())


def _cpu_replay(monkeypatch):
    _BodyGraph.made = []
    monkeypatch.setattr(GR, "Graph", _BodyGraph)
    monkeypatch.setattr(GR, "warm_up", lambda body, stream: body())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)


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
    steps[1]._lr.fill_(1e-3)          # what `_run` does before `_replay`
    copies = []
    real_copy = torch.Tensor.copy_
    monkeypatch.setattr(torch.Tensor, "copy_", lambda t, s, *a, **k: (
        copies.append(t.shape), real_copy(t, s, *a, **k))[1])
    first = steps[1]._replay([tuple(b[i] for b in placed)
                              for i in range(3)])
    copies.clear()
    one = steps[1]._place((ids[0], labels[0]))
    again = steps[1]._replay([one] * 3)
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
    graphed._lr.fill_(1e-3)           # what `_run` does before `_replay`

    def both(edit):
        for s in (eager, graphed):
            edit(s)
        want = eager.run_steps(*batch, repeat=2)
        return want, graphed._replay([placed, placed])

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


# ------------------------------------------------------------------ rules
def _tree(fn):
    return ast.parse(textwrap.dedent(inspect.getsource(fn)))


def _mentions_cpu_or_env(tree):
    text = ast.unparse(tree)
    return "cpu" in text or "environ" in text or "getenv" in text


def test_capture_and_replay_path_never_falls_back():
    """The CUDA path: `core.graphs`, the engine's capture and replay and
    the train step's replay hold no try/except, test no device and read
    no environment; the entries branch once, a CPU device to the body,
    everything else to the replay; no constructor can turn graphs off."""
    mod = ast.parse(inspect.getsource(GR))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(mod))
    assert "environ" not in inspect.getsource(GR)
    for fn in (GR.warm_up, GR.Graph.__init__, GR.Graph.replay,
               InferenceEngine._decode_program,
               InferenceEngine._capture_decode,
               InferenceEngine._replay_decode,
               TS.DistributedTrainStep._replay):
        tree = _tree(fn)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn
        if fn is not InferenceEngine._decode_program:
            assert not _mentions_cpu_or_env(tree), fn
    # the program builder captures on CUDA and never runs the body itself;
    # the capture reaches it only through the partial it records
    build = _tree(InferenceEngine._decode_program)
    assert "_decode_body" not in ast.unparse(build)
    for fn in (InferenceEngine._capture_decode,
               TS.DistributedTrainStep._replay):
        tree = _tree(fn)
        partials = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and ast.unparse(n.func) == "functools.partial"]
        assert len(partials) == 1, fn
        body = ast.unparse(partials[0].args[0])
        assert body in ("self._decode_body", "self._step"), fn
        assert ast.unparse(tree).count(body) == 1, fn
    for fn, body, replayed in (
            (InferenceEngine._run_decode, "self._decode_body",
             "self._replay_decode"),
            (TS.DistributedTrainStep._run, "self._step", "self._replay")):
        tree = _tree(fn)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
        ifs = [n for n in ast.walk(tree) if isinstance(n, ast.If)]
        assert len(ifs) == 1, fn
        assert ast.unparse(ifs[0].test) == "self._device.type == 'cpu'"
        cpu_side = ast.unparse(ast.Module(ifs[0].body, []))
        rest = ast.unparse(tree).replace(cpu_side, "")
        assert body in cpu_side and body not in rest, fn
        assert replayed in rest and replayed not in cpu_side, fn
    for ctor in (EngineConfig.__init__, InferenceEngine.__init__,
                 TS.DistributedTrainStep.__init__, build_train_step):
        names = list(inspect.signature(ctor).parameters)
        assert not any("graph" in n or "eager" in n for n in names), ctor
    assert EN.GR is GR and TS.GR is GR
