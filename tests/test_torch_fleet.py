"""The port's fleet plane on the CPU: the `Router` (a copy of the JAX
module) over fake replicas, held to the cases of the JAX
`tests/test_router.py` (least-loaded pick, heartbeat ejection and
re-admission, same-request-id failover, stream failover as an exact
prefix, mid-stream resume, sheds, drains); `ReplicaFleet`'s
drain-before-SIGTERM order with fake processes; the port's `TCPStore`
over `torch.distributed.TCPStore`, step by step against the JAX
package's store; and real replica processes (`python -m
paddle_tpu_torch.inference.fleet`): two `toy` replicas through kill,
failover, relaunch and drain with heartbeats through the store, their
tokens the JAX fleet's `toy_token`, and one `gpt` replica on the CPU
whose tokens equal an in-process `_build_gpt_engine(seed=0)` engine's,
an engine held to the JAX fleet's on carried weights.

Every router, server and fleet is shut down in a `finally`, every wait
has its own timeout, and no test starts more than two replica
processes.
"""
from __future__ import annotations

import gc
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.inference import fleet as FL
from paddle_tpu_torch.inference.fleet import ReplicaFleet
from paddle_tpu_torch.inference.router import ReplicaUnreachable, Router
from paddle_tpu_torch.inference.serving import (
    InferenceClient, StreamInterrupted,
)
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability import request_trace as rtrace
from paddle_tpu_torch.resilience.overload import ShedError


@pytest.fixture(autouse=True)
def _telemetry():
    metrics.reset()
    obs.attach(crash_hook=False)
    yield
    obs.detach()
    metrics.reset()


# --------------------------------------------------------------------------
# fake replica plane (as in tests/test_router.py, over the port's router)
# --------------------------------------------------------------------------

class _FakeStream:
    def __init__(self, status, lines, die_after=None):
        self.status = status
        self.headers = {}
        self._lines = list(lines)
        self._die_after = die_after

    def lines(self):
        for i, line in enumerate(self._lines):
            if self._die_after is not None and i >= self._die_after:
                raise ConnectionResetError("replica died mid-stream")
            yield line
        if self._die_after is not None:
            raise ConnectionResetError("replica died mid-stream")

    def read_body(self):
        return b"".join(self._lines)

    def close(self):
        pass


def _pos_token(prompt, i):
    """A position-only token function: any replica handed a delivered
    prefix re-derives the same continuation (the greedy contract)."""
    return (37 * (len(prompt) + i)) % 997


class _FakeReplica:
    """/ready signals, scripted /predict, and /generate streams that obey
    max_new_tokens (tokens `_pos_token`), with a log of every request."""

    def __init__(self, inflight=0, queued=0, limit=4, engine=None,
                 ready=True, reason="ok"):
        self.inflight, self.queued, self.limit = inflight, queued, limit
        self.engine = engine
        self.ready, self.reason = ready, reason
        self.dead = False
        self.fail_next_predicts = 0
        self.shed_next = 0
        self.requests, self.bodies = [], []
        self.stream_die_after = None

    def handle(self, method, path, body, headers):
        if self.dead:
            raise ReplicaUnreachable("fake replica down")
        if path == "/ready":
            body = {"status": "ready" if self.ready else "not_ready",
                    "reason": self.reason, "inflight": self.inflight,
                    "queued": self.queued, "limit": self.limit,
                    "admission_limit": self.limit}
            if self.engine is not None:
                body["engine"] = dict(self.engine)
            return (200 if self.ready else 503), {}, \
                json.dumps(body).encode()
        self.requests.append((path, dict(headers or {})))
        if self.fail_next_predicts > 0:
            self.fail_next_predicts -= 1
            raise ReplicaUnreachable("fake replica crashed")
        if self.shed_next > 0:
            self.shed_next -= 1
            return (429, {"Retry-After": "1"},
                    json.dumps({"error": "shed",
                                "reason": "queue_full"}).encode())
        return 200, {"Content-Type": "application/json"}, b'{"echo": 1}'

    def stream(self, path, body, headers):
        if self.dead:
            raise ReplicaUnreachable("fake replica down")
        self.requests.append((path, dict(headers or {})))
        if self.shed_next > 0:
            self.shed_next -= 1
            return _FakeStream(429, [json.dumps(
                {"error": "shed", "reason": "queue_full"}).encode()])
        req = json.loads(body or b"{}")
        self.bodies.append(req)
        prompt = req.get("input_ids", [])
        toks = [_pos_token(prompt, i)
                for i in range(int(req.get("max_new_tokens", 5)))]
        lines = [json.dumps({"token": t}).encode() + b"\n" for t in toks]
        lines.append(json.dumps({
            "done": True, "finish_reason": "length",
            "output_ids": list(prompt) + toks}).encode() + b"\n")
        return _FakeStream(200, lines, die_after=self.stream_die_after)


class _FakeTransport:
    def __init__(self, replicas):
        self.replicas = dict(replicas)

    def request(self, address, method, path, body=None, headers=None,
                timeout=30.0):
        rep = self.replicas.get(address)
        if rep is None:
            raise ReplicaUnreachable(f"no fake replica at {address}")
        return rep.handle(method, path, body, headers)

    def stream(self, address, path, body, headers=None, timeout=30.0):
        rep = self.replicas.get(address)
        if rep is None:
            raise ReplicaUnreachable(f"no fake replica at {address}")
        return rep.stream(path, body, headers)


class _FakeHandler:
    """What `forward_generate` writes to the client side."""

    class _W:
        def __init__(self):
            self.data = b""

        def write(self, b):
            self.data += b

        def flush(self):
            pass

    def __init__(self):
        self.wfile = self._W()
        self.status = None
        self.headers = []
        self._rt_ctx = None
        self.json_body = None

    def send_response(self, code):
        self.status = code

    def send_header(self, k, v):
        self.headers.append((k, v))

    def end_headers(self):
        pass

    def _json(self, code, obj, headers=()):
        self.status = code
        self.json_body = obj
        self.headers.extend(headers)

    def lines(self):
        return [json.loads(x) for x in self.wfile.data.splitlines()
                if x.strip()]


def _router(replicas, **kw):
    transport = _FakeTransport(
        {f"fake://{rid}": rep for rid, rep in replicas.items()})
    r = Router(replicas={rid: f"fake://{rid}" for rid in replicas},
               transport=transport, **kw)
    r.probe_once()
    return r


def _close(router):
    router._httpd.server_close()


def _eng(active=0, waiting=0):
    return dict(max_slots=4, waiting_sequences=waiting,
                active_sequences=active, batch_occupancy=active / 4.0)


def _gen_body(prompt, n=8):
    return json.dumps({"input_ids": prompt, "max_new_tokens": n}).encode()


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("endpoint", ["predict", "generate"])
def test_pick_least_loaded(endpoint):
    reps = {"full": _FakeReplica(inflight=3, queued=2,
                                 engine=_eng(4, 3)),
            "idle": _FakeReplica(engine=_eng()),
            "half": _FakeReplica(inflight=2, engine=_eng(2))}
    r = _router(reps)
    try:
        assert r._pick(endpoint) == "idle"
        assert r._pick(endpoint, exclude={"idle"}) == "half"
    finally:
        _close(r)


def test_ejection_on_missed_heartbeats_and_readmission():
    alive = {"a", "b"}
    reps = {"a": _FakeReplica(), "b": _FakeReplica()}
    r = _router(reps, heartbeats=lambda: alive, heartbeat_miss_k=3)
    try:
        assert r.replica_summary() == {"a": "up", "b": "up"}
        alive.discard("a")
        r.probe_once()
        r.probe_once()
        assert r.replica_summary()["a"] == "up"        # below K
        r.probe_once()
        assert r.replica_summary()["a"] == "ejected"
        assert r._pick("predict") == "b"
        assert metrics.snapshot()["counters"]["router.ejections"] == 1
        alive.add("a")
        r.probe_once()
        assert r.replica_summary()["a"] == "up"
        assert metrics.snapshot()["counters"]["router.readmissions"] >= 1
    finally:
        _close(r)


def test_failover_reuses_same_request_id():
    reps = {"a": _FakeReplica(), "b": _FakeReplica(inflight=5)}
    r = _router(reps, failover_retries=2)
    try:
        ctx = rtrace.new_context()
        reps["a"].fail_next_predicts = 1
        code, _h, _d, rid = r.forward_predict(b"payload", ctx)
        assert code == 200 and rid == "b"
        assert metrics.snapshot()["counters"]["router.failovers"] == 1
        ids = {h.get("X-Request-Id") for rep in reps.values()
               for path, h in rep.requests if path == "/predict"}
        assert ids == {ctx.request_id}
    finally:
        _close(r)


def test_no_routable_replica_sheds_503():
    reps = {"a": _FakeReplica()}
    r = _router(reps)
    try:
        reps["a"].dead = True
        for _ in range(r.heartbeat_miss_k):
            r.probe_once()
        with pytest.raises(ShedError) as ei:
            r.forward_predict(b"x", rtrace.new_context())
        assert (ei.value.reason, ei.value.http_status) == \
            ("no_replicas", 503)
        assert r.readiness() == (False, "no_replicas")
    finally:
        _close(r)


@pytest.mark.parametrize("how", ["readiness", "mark_draining"])
def test_draining_replica_leaves_rotation(how):
    reps = {"a": _FakeReplica(), "b": _FakeReplica(inflight=3)}
    r = _router(reps)
    try:
        assert r._pick("predict") == "a"
        if how == "readiness":
            reps["a"].ready, reps["a"].reason = False, "draining"
            r.probe_once()
        else:
            r.mark_draining("a")
        assert r.replica_summary()["a"] == "draining"
        assert r._pick("predict") == "b"
    finally:
        _close(r)


# --------------------------------------------------------------------------
# /generate stream failover
# --------------------------------------------------------------------------

def test_stream_zero_token_failover_is_transparent():
    reps = {"a": _FakeReplica(engine=_eng()),
            "b": _FakeReplica(engine=_eng(1))}
    r = _router(reps, failover_retries=2)
    try:
        reps["a"].stream_die_after = 0          # dies before any line
        h = _FakeHandler()
        prompt = [3, 4]
        status = r.forward_generate(_gen_body(prompt), prompt,
                                    rtrace.new_context(), h)
        assert status == "ok"
        lines = h.lines()
        assert [ln["token"] for ln in lines[:-1]] == \
            [_pos_token(prompt, i) for i in range(8)]
        assert lines[-1]["done"] is True
        assert metrics.snapshot()["counters"]["router.failovers"] >= 1
    finally:
        _close(r)


def test_stream_mid_failure_interrupts_with_exact_prefix():
    """With no survivor, a stream cut after 3 tokens ends in one
    `interrupted` record whose output_ids are the prompt and exactly the
    delivered tokens; no other replica saw the request."""
    reps = {"a": _FakeReplica(engine=_eng())}
    r = _router(reps, failover_retries=2)
    try:
        reps["a"].stream_die_after = 3
        h = _FakeHandler()
        prompt = [9, 9, 1]
        status = r.forward_generate(_gen_body(prompt), prompt,
                                    rtrace.new_context(), h)
        assert status == "interrupted"
        lines = h.lines()
        toks = [ln["token"] for ln in lines if "token" in ln]
        assert toks == [_pos_token(prompt, i) for i in range(3)]
        final = lines[-1]
        assert final["interrupted"] is True
        assert final["finish_reason"] == "replica_lost"
        assert final["output_ids"] == prompt + toks
        assert len(reps["a"].requests) == 1
    finally:
        _close(r)


def test_stream_mid_failure_resumes_on_survivor():
    """A replica dying with 3 tokens delivered: the router resubmits the
    prompt and the delivered tokens but the last to the survivor under
    the same request id, swallows the re-derived verify token, and the
    client sees one 8-token stream, no token replayed or skipped."""
    reps = {"a": _FakeReplica(engine=_eng(0)),
            "b": _FakeReplica(engine=_eng(1))}
    r = _router(reps, failover_retries=0, stream_resume_max=2)
    try:
        ctx = rtrace.new_context()
        assert r._pick("generate") == "a"
        reps["a"].stream_die_after = 3
        h = _FakeHandler()
        prompt = [3, 4]
        status = r.forward_generate(_gen_body(prompt), prompt, ctx, h,
                                    max_new_tokens=8)
        assert status == "ok"
        lines = h.lines()
        toks = [ln["token"] for ln in lines if "token" in ln]
        assert toks == [_pos_token(prompt, i) for i in range(8)]
        assert lines[-1]["done"] is True and lines[-1]["resumed"] == 1
        (leg,) = reps["b"].bodies
        assert leg["input_ids"] == prompt + toks[:2]
        assert leg["max_new_tokens"] == 8 - 3 + 1
        assert leg["prebilled_tokens"] == 1 and leg["resume"] == 1
        assert reps["b"].requests[0][1]["X-Request-Id"] == ctx.request_id
        assert metrics.snapshot()["counters"][
            "router.stream_resumes{outcome=ok}"] == 1
    finally:
        _close(r)


def test_stream_all_replicas_shedding_returns_429():
    reps = {"a": _FakeReplica(engine=dict(max_slots=2))}
    r = _router(reps)
    try:
        reps["a"].shed_next = 5
        h = _FakeHandler()
        status = r.forward_generate(_gen_body([1]), [1],
                                    rtrace.new_context(), h)
        assert status == "shed" and h.status == 429
        assert h.json_body.get("reason") == "queue_full"
    finally:
        _close(r)


# --------------------------------------------------------------------------
# ReplicaFleet with fake processes: drain order
# --------------------------------------------------------------------------

class _FakeProc:
    def __init__(self, record, rank):
        self.record, self.rank, self.rc = record, rank, None
        self.pid = 90000 + rank

    def poll(self):
        return self.rc

    def wait(self, timeout=None):
        return self.rc

    def send_signal(self, sig):
        self.record.append(("signal", self.rank, int(sig)))
        self.rc = 0

    def kill(self):
        self.record.append(("kill", self.rank))
        self.rc = -9


def test_fleet_drain_marks_router_before_sigterm(tmp_path):
    """Rotation out and router-side in-flight at zero strictly before the
    signal."""
    record = []
    reps = {"r0": _FakeReplica(), "r1": _FakeReplica()}
    router = Router(transport=_FakeTransport(
        {f"fake://{rid}": rep for rid, rep in reps.items()}),
        probe_interval=0.02)

    def spawner(handle, cmd, env):
        assert cmd[1:3] == ["-m", "paddle_tpu_torch.inference.fleet"]
        with open(handle.announce + ".tmp", "w") as f:
            json.dump({"address": f"fake://{handle.rid}"}, f)
        os.replace(handle.announce + ".tmp", handle.announce)
        return _FakeProc(record, handle.rank)

    fleet = ReplicaFleet(num_replicas=2, router=router, heartbeat=False,
                         spawner=spawner, workdir=str(tmp_path),
                         max_restarts=0, monitor_interval=0.02)
    fleet.start()
    try:
        assert router.replica_summary() == {"r0": "up", "r1": "up"}
        router._begin_forward("r0", "predict")
        at_signal = {}
        orig = _FakeProc.send_signal

        def instrumented(self, sig):
            at_signal["state"] = router.replica_summary()["r0"]
            at_signal["inflight"] = router.inflight_to("r0")
            orig(self, sig)

        _FakeProc.send_signal = instrumented
        try:
            th = threading.Thread(target=fleet.drain_replica, args=(0,),
                                  kwargs={"grace": 5.0}, daemon=True)
            th.start()
            time.sleep(0.1)
            assert "state" not in at_signal          # still quiescing
            router._end_forward("r0", "predict")
            th.join(timeout=5)
            assert not th.is_alive()
        finally:
            _FakeProc.send_signal = orig
        assert at_signal == {"state": "draining", "inflight": 0}
        kinds = [e["kind"] for e in fleet.events]
        assert kinds.index("drain_mark") < kinds.index("drain_sigterm")
        assert ("signal", 0, 15) in record
    finally:
        fleet.stop()


# --------------------------------------------------------------------------
# the heartbeat store
# --------------------------------------------------------------------------

def _free_store(cls=TCPStore, **kw):
    base = 21000 + (os.getpid() * 11) % 20000
    for k in range(16):
        try:
            return cls("127.0.0.1", base + k * 7, is_master=True, **kw)
        except OSError:
            continue
    raise RuntimeError("no free port for the store")


def _store_script(cls):
    """One script of store operations, each step's outcome as (step,
    result or exception type): str and bytes values, get, add, check,
    a get and a wait that time out, a two-rank barrier twice, a taken
    port, a connect that fails, and set / add / get once the master is
    gone."""
    out = []

    def step(name, fn):
        try:
            out.append((name, fn()))
        except Exception as e:
            out.append((name, type(e).__name__))

    master = _free_store(cls, world_size=2, timeout=10.0)
    client = cls("127.0.0.1", master.port, world_size=2, timeout=10.0)
    step("set str", lambda: master.set("a", "1.5"))
    step("set bytes", lambda: client.set("b", b"\x00\xff"))
    step("get", lambda: (client.get("a"), master.get("b"),
                         type(client.get("a")).__name__))
    step("add", lambda: (master.add("n", 2), client.add("n", 3)))
    step("check", lambda: (client.check("a"), client.check("missing")))
    t0 = time.monotonic()
    step("get times out", lambda: client.get("missing", timeout=0.2))
    step("wait times out", lambda: client.wait(["a", "missing"],
                                               timeout=0.2))
    out.append(("timeouts under 5 s", time.monotonic() - t0 < 5.0))

    def barrier_twice():
        th = threading.Thread(target=lambda: (master.barrier(),
                                              master.barrier()),
                              daemon=True)
        th.start()
        client.barrier()
        client.barrier()
        th.join(timeout=10)
        return not th.is_alive()
    step("barrier twice", barrier_twice)
    step("bind a taken port", lambda: cls("127.0.0.1", master.port,
                                          is_master=True, timeout=2.0))
    dead = _free_store(cls, timeout=2.0)
    port = dead.port
    del dead
    gc.collect()
    step("connect fails", lambda: cls("127.0.0.1", port, timeout=1.0))
    del master
    gc.collect()
    time.sleep(0.2)
    step("set, master gone", lambda: client.set("c", b"1"))
    step("add, master gone", lambda: client.add("n", 1))
    step("get, master gone", lambda: client.get("a", timeout=0.5))
    return out


def test_store_keeps_the_jax_stores_conventions():
    """The port's TCPStore (over `torch.distributed.TCPStore`) and the
    JAX package's (over its native server) give the same results and
    the same exception types, step by step, for one script of
    operations (JAX `distributed/store.py`)."""
    from paddle_tpu.distributed.store import TCPStore as JTCPStore

    want = _store_script(JTCPStore)
    got = _store_script(TCPStore)
    assert got == want
    assert dict(want)["get"] == (b"1.5", b"\x00\xff", "bytes")
    assert dict(want)["connect fails"] == "ConnectionError"


def test_store_refuses_a_taken_port():
    master = _free_store(timeout=5.0)
    with pytest.raises(OSError):
        TCPStore("127.0.0.1", master.port, is_master=True, timeout=5.0)


# --------------------------------------------------------------------------
# real replica processes
# --------------------------------------------------------------------------

def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _serving_rank(fleet):
    """The rank the router is forwarding a request to."""
    return next(h.rank for h in list(fleet._handles.values())
                if fleet.router.inflight_to(h.rid) > 0)


def test_toy_fleet_kill_failover_relaunch_drain():
    """Two `toy` replicas behind the router, heartbeating through the
    port's TCPStore: a stream cut by a hard kill is an exact prefix of
    the true sequence (completed through failover or resumable through
    StreamInterrupted); the monitor relaunches the replica and the
    router re-admits it; a drained replica finishes its in-flight
    stream."""
    fleet = ReplicaFleet(num_replicas=2, kind="toy", token_time=0.02,
                         launch_timeout=120, monitor_interval=0.1)
    fleet.start(ready_timeout=120)
    try:
        _wait(lambda: fleet._alive_replicas() == {"r0", "r1"}, 30,
              "both replicas' heartbeats")
        from paddle_tpu.inference.fleet import toy_token as jax_toy_token

        cli = InferenceClient(fleet.router.address, timeout=30, retries=2)
        prompt = [5, 1, 7]
        true = [jax_toy_token(prompt, i) for i in range(40)]
        r = cli.generate(prompt, max_new_tokens=8)
        assert r["tokens"] == true[:8]

        got, out = [], {}

        def stream():
            try:
                out["r"] = cli.generate(prompt, max_new_tokens=40,
                                        on_token=got.append)
            except StreamInterrupted as e:
                out["e"] = e

        th = threading.Thread(target=stream, daemon=True)
        th.start()
        _wait(lambda: len(got) >= 3, 30, "the first tokens")
        fleet.kill_replica(_serving_rank(fleet))
        th.join(timeout=60)
        assert not th.is_alive()
        if "r" in out:
            assert out["r"]["tokens"] == true
        else:
            e = out["e"]
            assert e.tokens == true[:len(e.tokens)]
            assert list(e.output_ids) == prompt + e.tokens
        assert got == true[:len(got)]
        _wait(lambda: any(ev["kind"] == "replica_relaunched"
                          for ev in fleet.events), 60, "the relaunch")
        assert fleet.wait_ready(n=2, timeout=60), fleet.describe()
        # a drained replica finishes what it serves, then exits 0
        got.clear()
        out.clear()
        th = threading.Thread(target=stream, daemon=True)
        th.start()
        _wait(lambda: len(got) >= 2, 30, "the drained stream's tokens")
        assert fleet.drain_replica(_serving_rank(fleet), grace=30.0)
        th.join(timeout=60)
        assert out["r"]["tokens"] == true
        _wait(lambda: any(ev["kind"] == "replica_exit"
                          and ev.get("drained") and ev["rc"] == 0
                          for ev in fleet.events), 30, "the clean exit")
    finally:
        fleet.stop()


def test_fleet_gpt_engine_is_the_jax_fleets_engine():
    """The `gpt` replica's engine against the JAX fleet's: the same
    model and engine configurations, and with the JAX engine's seeded
    weights carried across (`load_reference_state`) the same greedy
    tokens, so the in-process port engine the replica is held to below
    stands for the JAX one."""
    from paddle_tpu.inference import fleet as JFL
    from paddle_tpu_torch.models.gpt import load_reference_state

    jeng = JFL._build_gpt_engine(seed=0)
    teng = FL._build_gpt_engine(seed=0, device="cpu")
    jm, tm = jeng._model, teng._model
    jcfg = vars(jm.cfg)
    assert vars(tm.cfg) == {k: jcfg[k] for k in vars(tm.cfg)}
    for k in ("page_size", "max_slots", "decode_chunk", "max_seq_len",
              "prefix_cache", "kv_precision"):
        assert getattr(teng.config, k) == getattr(jeng.config, k), k
    params, _ = jm.functional_state()
    load_reference_state(tm, {k: np.asarray(v) for k, v in params.items()})
    prompts = [np.arange(1, 9, dtype=np.int32),
               np.arange(20, 31, dtype=np.int32)]
    want = jeng.generate(prompts, max_new_tokens=6)
    got = teng.generate(prompts, max_new_tokens=6)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_gpt_replica_on_cpu_streams_the_in_process_engines_tokens():
    """One `gpt` replica with device="cpu": it warms up before it
    announces, its router streams equal an in-process
    `_build_gpt_engine(seed=0, device="cpu")` engine's tokens, its
    /ready carries the engine's stats, and its /debug/telemetry counts
    the routed requests' prefills and decode steps from its announce
    (its warm-up not among them; on the CPU no kernel launches)."""
    prompts = [np.arange(1, 9, dtype=np.int32),
               np.arange(20, 31, dtype=np.int32)]
    want = FL._build_gpt_engine(seed=0, device="cpu").generate(
        prompts, max_new_tokens=6)
    fleet = ReplicaFleet(num_replicas=1, kind="gpt", device="cpu",
                         launch_timeout=120, heartbeat=False)
    fleet.start(ready_timeout=120)
    try:
        cli = InferenceClient(fleet.router.address, timeout=60)
        for p, w in zip(prompts, want):
            r = cli.generate(p, max_new_tokens=6)
            np.testing.assert_array_equal(r["output_ids"], w)
        addr = fleet._handles[0].address
        ready = InferenceClient(addr, timeout=30).ready()
        assert ready["ready"] and ready["engine"]["max_slots"] == 4
        with urllib.request.urlopen(addr + "/debug/telemetry",
                                    timeout=30) as r:
            kern = json.loads(r.read())["kernels"]
        assert kern["prefills"] == len(prompts)
        assert kern["decode_chunk"] == 2
        # 5 tokens after each prefill's first, 2 a step, one or both
        # sequences a step
        assert 3 <= kern["decode_steps"] <= 6
        assert not any(kern["launches"].values())
        view = fleet.lifecycle.fleet_view()
        (rec,) = view["records"]
        phases = rec["replica"]["phases"]
        assert phases["warmup"]["mono_ms"] <= phases["announce"]["mono_ms"]
        assert rec["supervisor_ms"]["first_probe_up"] > 0
    finally:
        fleet.stop()
