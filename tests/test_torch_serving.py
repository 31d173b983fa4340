"""The port's serving plane on the CPU, in float32: `POST /generate` over
HTTP through the port's `InferenceServer` and engine, held against the
JAX `InferenceServer` over the JAX engine on the same weights.

Covered: concurrent streams equal the JAX server's and the in-process
engine's tokens; the JAX server's `/health` and `/ready` keys; a bad body
gives 400 with the request id echoed; a shed retries under the same
request id; a client that disconnects mid-stream frees its slot and
pages; capture timing (`observability.capture_cost`) reaches the
lifecycle ledger, a span and a flight event under the JAX programs'
labels, through the stand-in graph of `tests/test_torch_graphs.py`.
Saved-model serving (`model_path=`) is `tests/test_torch_saved_serving.py`.  Every server is shut
down in a `finally` and every wait has a timeout of its own.
"""
from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.inference.engine import EngineConfig as JEngineConfig
from paddle_tpu.inference.engine import InferenceEngine as JEngine
from paddle_tpu.inference.serving import InferenceServer as JServer
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core import graphs as GR
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from paddle_tpu_torch.inference.engine import engine as EN
from paddle_tpu_torch.models.gpt import (
    GPTConfig, GPTForCausalLM, load_reference_state,
)
from paddle_tpu_torch.observability import flight, lifecycle, metrics, trace

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)
ENGINE = dict(page_size=8, max_slots=2, max_seq_len=64)
NEW = 8


@pytest.fixture(scope="module")
def models():
    P.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    params, _ = jm.functional_state()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    return jm, tm


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(0)
    ps = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (3, 9, 17, 5)]
    shared = rs.randint(0, 128, (16,)).astype(np.int32)
    ps += [np.concatenate([shared, rs.randint(0, 128, (n,)).astype(
        np.int32)]) for n in (3, 7)]
    return ps


@pytest.fixture(scope="module")
def servers(models):
    """The port's server over the port's engine and the JAX server over
    the JAX engine, on the same weights."""
    jm, tm = models
    metrics.reset()
    obs.attach(crash_hook=False)
    port = S.InferenceServer(
        engine=InferenceEngine(tm, EngineConfig(**ENGINE)),
        request_timeout=60.0).start()
    try:
        ref = JServer(engine=JEngine(jm, JEngineConfig(**ENGINE)),
                      request_timeout=60.0).start()
    except BaseException:
        port.shutdown()
        raise
    try:
        yield port, ref
    finally:
        port.shutdown()
        ref.shutdown()
        obs.detach()
        metrics.reset()


def _stream_all(address, prompts, new=NEW):
    """Every prompt through its own client at once: (streamed tokens,
    final record) per prompt."""
    out = [None] * len(prompts)

    def one(i):
        got = []
        cli = S.InferenceClient(address, timeout=60.0)
        r = cli.generate(prompts[i], max_new_tokens=new,
                         on_token=got.append)
        out[i] = (got, r)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a stream hung"
    assert all(o is not None for o in out), "a stream failed"
    return out


def _drained(eng, timeout=10.0):
    """The engine holds no sequence and no page but the prefix cache's."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = eng.stats()
        pages = eng.pool.stats()
        if st["running"] == 0 and st["waiting"] == 0 \
                and pages["logical_pages"] == pages["used"]:
            return True
        time.sleep(0.02)
    return False


def test_http_streams_equal_jax_server_and_engine(servers, models,
                                                  prompts):
    """Concurrent streams through the port's `POST /generate` equal the
    JAX server's for the same prompts, token for token, and the port
    engine's in-process tokens; each stream equals its final record."""
    port, ref = servers
    _, tm = models
    want = InferenceEngine(tm, EngineConfig(**ENGINE)).generate(
        prompts, max_new_tokens=NEW)
    got = _stream_all(port.address, prompts)
    jax = _stream_all(ref.address, prompts)
    for p, w, (toks, r), (jtoks, jr) in zip(prompts, want, got, jax):
        assert toks == jtoks
        np.testing.assert_array_equal(r["output_ids"], jr["output_ids"])
        np.testing.assert_array_equal(r["output_ids"], w)
        assert toks == r["tokens"] == [int(t) for t in w[len(p):]]
        assert r["finish_reason"] == jr["finish_reason"] == "length"
    assert _drained(port.engine)


def _get(address, path):
    try:
        with urllib.request.urlopen(address + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _keys(d, prefix=""):
    """Every key path of a JSON object, nested objects included."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("path", ["/health", "/ready"])
def test_health_and_ready_carry_the_jax_servers_keys(servers, path):
    port, ref = servers
    code, body = _get(port.address, path)
    jcode, jbody = _get(ref.address, path)
    assert code == jcode == 200
    assert _keys(body) == _keys(jbody)
    assert "engine" in body
    if path == "/ready":
        assert body["engine"]["max_slots"] == ENGINE["max_slots"]


def test_metrics_and_debug_surfaces_render(servers):
    port, _ = servers
    with urllib.request.urlopen(port.address + "/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    assert r.status == 200 and "serving_requests" in text
    for path in ("/debug/telemetry", "/debug/lifecycle",
                 "/debug/timeseries", "/debug/tenants"):
        code, body = _get(port.address, path)
        assert code == 200, (path, body)
    code, snap = _get(port.address, "/debug/telemetry")
    assert snap["lifecycle"]["schema"] == "lifecycle/v1"
    assert snap["engine"]["max_slots"] == ENGINE["max_slots"]


def test_bad_body_gives_400_with_request_id_echoed(servers):
    port, _ = servers
    req = urllib.request.Request(
        port.address + "/generate", data=b"not json",
        headers={"Content-Type": "application/json",
                 "X-Request-Id": "bad-body-req"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400
    assert ei.value.headers.get("X-Request-Id") == "bad-body-req"


def test_shed_retries_under_the_same_request_id(models, prompts):
    """Saturate the engine's admission (one slot busy, queue 0): a
    retrying client sheds with 429 and Retry-After, then succeeds under
    the same X-Request-Id (JAX `tests/test_engine.py`
    `test_generate_shed_retries_same_request_id`)."""
    _, tm = models
    metrics.reset()
    obs.attach(crash_hook=False)
    eng = InferenceEngine(tm, EngineConfig(page_size=8, max_slots=1,
                                           max_seq_len=64))
    srv = S.InferenceServer(engine=eng, request_timeout=60.0,
                            queue_depth=0).start()
    gate = threading.Event()
    try:
        seen, orig = [], eng.submit

        def spy(ids, **kw):
            seen.append(kw.get("request_id"))
            return orig(ids, **kw)

        eng.submit = spy
        # the blocker holds the slot until the gate opens: its stream
        # waits in `on_token` after the first token
        done = threading.Event()

        def long_one():
            S.InferenceClient(srv.address, timeout=60.0).generate(
                prompts[1], max_new_tokens=4,
                on_token=lambda t: gate.wait(timeout=30))
            done.set()

        th = threading.Thread(target=long_one, daemon=True)
        th.start()
        deadline = time.monotonic() + 30
        while srv.gen_admission.stats()["inflight"] < 1:
            assert time.monotonic() < deadline, "the blocker never ran"
            time.sleep(0.005)
        sleeps = []

        def sleep(s):
            sleeps.append(s)
            gate.set()                 # the slot frees after a shed
            time.sleep(s)

        cli = S.InferenceClient(srv.address, timeout=60.0, retries=60,
                                max_retry_wait=0.5, sleep=sleep)
        r = cli.generate(prompts[0], max_new_tokens=4)
        th.join(timeout=60)
        assert done.is_set() and len(r["tokens"]) == 4
        assert sleeps, "the request was never shed"
        # one engine submission, under the id the shed attempts carried
        assert r["request_id"] in seen and seen.count(r["request_id"]) == 1
        counters = metrics.snapshot()["counters"]
        assert sum(v for k, v in counters.items()
                   if k.startswith("client.requests")
                   and "shed_retry" in k) >= 1
        slo = srv.slo.report(publish_gauges=False)
        errs = slo["endpoints"]["generate"]["errors_by_reason"]
        assert sum(v for k, v in errs.items() if k.startswith("shed:")) >= 1
    finally:
        gate.set()
        srv.shutdown()
        obs.detach()
        metrics.reset()


def test_disconnect_mid_stream_frees_slot_and_pages(models, prompts):
    """A client that drops after its first token: the server cancels the
    sequence, so the engine ends with no sequence and no page in use but
    the prefix cache's."""
    _, tm = models
    eng = InferenceEngine(tm, EngineConfig(page_size=8, max_slots=1,
                                           max_seq_len=64,
                                           prefix_cache=False))
    decode, cancelled = eng._decode, []

    def slow_decode(running):        # keeps the stream open for a while
        time.sleep(0.02)
        decode(running)

    eng._decode = slow_decode
    cancel = eng.cancel
    eng.cancel = lambda rid: cancelled.append(rid) or cancel(rid)
    srv = S.InferenceServer(engine=eng, request_timeout=60.0).start()
    try:
        host, port = srv.address[len("http://"):].split(":")
        body = json.dumps({"input_ids": [int(x) for x in prompts[2]],
                           "max_new_tokens": 40}).encode()
        with socket.create_connection((host, int(port)), timeout=30) as s:
            s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n"
                      + f"Content-Length: {len(body)}\r\n\r\n".encode()
                      + body)
            got = b""
            while b'{"token"' not in got:
                chunk = s.recv(4096)
                assert chunk, "the stream closed before a token"
                got += chunk
        deadline = time.monotonic() + 30
        while not cancelled:
            assert time.monotonic() < deadline, "the server never cancelled"
            time.sleep(0.02)
        assert _drained(eng, timeout=30), eng.stats()
        assert eng.pool.used_pages == 0 and eng.steps < 40
        # the slot serves the next request
        r = S.InferenceClient(srv.address, timeout=60.0).generate(
            prompts[0], max_new_tokens=3)
        assert len(r["tokens"]) == 3
    finally:
        srv.shutdown()


# ------------------------------------------------------- capture timing
class _BodyGraph:
    """The stand-in graph of tests/test_torch_graphs.py: the capture runs
    nothing, a replay runs the captured body."""

    made = []

    def __init__(self, body, stream, pool=None, generators=()):
        self.body, self.outputs, self.replays = body, torch.zeros(()), 0
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


@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_capture_timing_reaches_the_ledger_under_jax_labels(
        monkeypatch, models, prompts, tier):
    """Each capture of the engine (cold and warm prefill, decode), of a
    `StaticFunction`, of a train step and of a `generate()` decode
    chunk, through the stand-in graph, lands in the lifecycle ledger
    under the label of the JAX program whose role it takes (the chunk:
    `decode_chunk_n{n}`), with its warm-up and capture ms, in a
    `graph.capture:<label>` span and a `graph.capture` flight event."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.jit import api as JA
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.optimizer import AdamW

    _, tm = models
    lifecycle.reset()
    metrics.reset()
    obs.attach(crash_hook=False)
    flight.clear()
    trace.clear()
    try:
        _cpu_replay(monkeypatch)
        eng = InferenceEngine(tm, EngineConfig(
            page_size=4, max_slots=2, max_seq_len=64,
            kv_precision=None if tier == "exact" else "int8"))

        def cuda_path(prog, ids, start, pages, plen=0, prefix_pages=None):
            eng._load_prefill(prog, ids, start, pages, plen, prefix_pages)
            eng._replay_prefill(prog)
            return int(prog.tok[0])

        eng._run_prefill_program = cuda_path
        eng.generate(prompts, max_new_tokens=3)
        eng.generate(prompts[-1:], max_new_tokens=3)     # a prefix hit
        with torch.inference_mode():
            eng._capture_decode(2, eng._decode_program(2))
        q = "_q" if tier == "int8" else ""
        want = {"decode_n2"} | {
            f"prefill_s{p.sb}" if p.npp is None
            else f"cprefill_s{p.sb}_p{p.npp}{q}"
            for p in eng._prefills.values()}
        assert any(k.startswith("cprefill") for k in want)
        if tier == "exact":
            lin = torch.nn.Linear(4, 4)
            sf = JA.StaticFunction(lin)
            with torch.no_grad():
                sf._replay((torch.ones(2, 4),), {}, torch.device("cuda", 0))
            cfg = TG.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                               num_heads=2, max_seq_len=16)
            m = TG.GPTForCausalLM(cfg, device="cpu", seed=4)
            step = build_train_step(m, AdamW(learning_rate=1e-3),
                                    TG.GPTPretrainingCriterion(model=m))
            ids = np.zeros((2, 16), np.int32)
            step._replay([step._place((ids, ids))], [1e-3])
            # generate()'s decode chunk of 4 steps
            from paddle_tpu_torch.models import generation as GEN

            with torch.inference_mode():
                st = tm._chunk_state(GEN._generation(tm), 2, 14)
                prog = st.programs.setdefault(
                    (4, False, None), GEN._ChunkProgram(2, 4, "cpu"))
                st.pos0.fill_(5)
                tm._replay_chunk(st, prog, False, None)
            want |= {"jit::forward", "train_step", "decode_chunk_n4"}
        compiles = lifecycle.get_ledger().record()["compiles"]
        assert set(compiles) == want
        assert len(_BodyGraph.made) == len(want)
        for label, c in compiles.items():
            assert c["count"] == 1, label
            assert c["lower_ms"] >= 0 and c["compile_ms"] >= 0, label
        events = {e["label"]: e for e in flight.events()
                  if e["kind"] == "graph.capture"}
        assert set(events) == want
        spans = {s["name"] for s in trace.events()
                 if s.get("cat") == "compile"}
        assert {f"graph.capture:{k}" for k in want} <= spans
        gauges = metrics.snapshot()["gauges"]
        assert any("lifecycle.compile_ms" in k and "decode_n2" in k
                   for k in gauges)
    finally:
        obs.detach()
        metrics.reset()
        lifecycle.reset()
