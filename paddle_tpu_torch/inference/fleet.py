"""ReplicaFleet: launch, supervise, and heal N InferenceServer replicas
(``paddle_tpu/inference/fleet.py`` counterpart).

The process-lifecycle half of the fleet serving story.  A `ReplicaFleet`:

  * **launches** `num_replicas` replica subprocesses (`python -m
    paddle_tpu_torch.inference.fleet --replica ...`), each an ordinary
    `InferenceServer` with a `PreemptionGuard` installed — every
    single-process reflex (admission control, graceful drain, engine
    cancel/reclaim) is reused verbatim inside each replica.
  * **watches liveness two ways**: process exit (immediate
    `router.note_replica_down`) and `fleet/elastic.py` heartbeats —
    each replica registers an `ElasticManager` beating into the
    fleet's TCPStore; the router ejects a replica that misses
    `heartbeat_miss_k` beats even when its process is merely wedged.
  * **relaunches** dead replicas (bounded by `max_restarts` per rank)
    and re-points the router at the new address; the router re-admits
    the replica only after it passes readiness.
  * **drains deliberately**: `drain_replica(rank)` takes the replica
    out of the router's rotation FIRST, waits for router-side
    in-flight traffic toward it to reach zero, and only then delivers
    SIGTERM — the replica's own `PreemptionGuard` finishes in-flight
    work and exits 0.  No thundering 503s, no severed requests.
  * **resizes at runtime**: `add_replica()` grows the fleet
    by one (fresh rank, spawned + announced + registered with the
    router, readiness-gated into rotation like any launch) and
    `remove_replica(rank)` shrinks it through the zero-loss drain
    protocol above, then retires the rank — the monitor never
    relaunches a removed rank, and `stop()` sweeps whatever membership
    exists at stop time, not the `__init__` roster.  The
    `inference.autoscaler.Autoscaler` drives both off the SLO burn
    rate and edge-admission occupancy.

Replica kinds (`--kind`): `echo` (stdlib+numpy predict-only stub —
fast startup, the unit/chaos workhorse), `toy` (echo predict + the
deterministic `ToyEngine` token streamer, for /generate failover
proofs without a model), `gpt` (the port's paged-KV `InferenceEngine`
over a small seeded GPT), `model` (a saved-model predictor via
`--model-path`: a prefix `static.save_inference_model` wrote, served as
`InferenceServer(model_path=)` does, as JAX does at :876-881).

Where the port departs from the JAX fleet:
  * `gpt` and `model` replicas run on the CUDA device by default, as
    every entry point of the port does: `ReplicaFleet(device=None)` and
    the replica's `--device` default to ``cuda`` and resolve through
    `core.device.resolve_device`, which raises on a host without CUDA
    (the CPU tests pass ``device="cpu"``).  Several replicas on one card
    are several CUDA contexts; each builds (or loads) the kernels at
    first use under the build lock (`ops/kernels/_build.py`);
  * a `gpt` replica warms up (a two-token generate: its first prefill
    and decode programs captured as CUDA graphs), a `model` replica
    runs one predict at the saved signature (zeros; a dynamic dim 1:
    its program captured as a CUDA graph), before its server starts and
    before it announces, and a warm-up that fails exits the replica
    non-zero: the supervisor sees a crash, not a replica whose first
    client request would meet the failed capture (ROADMAP C2.8).  The
    JAX replica logs a failed warm-up and announces anyway.

Env knobs:
  PADDLE_TPU_FLEET_REPLICAS     default replica count           (2)
  PADDLE_TPU_HEARTBEAT_MISS_K   router ejection threshold       (3)
  PADDLE_TPU_FAILOVER_RETRIES   router failover budget          (2)

Chaos fault point `replica.crash` fires every replica main-loop tick:
kind="error" exits the replica non-zero (a crash); any other kind is
an immediate `os._exit(137)` — a simulated kill -9.
"""
from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid

import numpy as np

from ..observability import lifecycle as _lifecycle
from ..resilience.overload import _env_num

__all__ = ["ReplicaFleet", "ToyEngine", "EchoPredictor", "toy_token"]

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# deterministic stand-ins (tests / chaos / any-process parity)
# ---------------------------------------------------------------------------

class EchoPredictor:
    """Stdlib+numpy predictor: sleeps `service_time` then echoes its
    input — deterministic across replicas, so a failed-over request's
    response is bit-identical to the one the dead replica would have
    sent."""

    def __init__(self, service_time=0.0):
        self.service_time = float(service_time)

    def get_input_names(self):
        return ["x"]

    def get_output_names(self):
        return ["y"]

    def run(self, inputs):
        if self.service_time:
            time.sleep(self.service_time)
        return [np.asarray(inputs[0])]


def toy_token(prompt_ids, i):
    """The ToyEngine's token function: a pure function of (prompt,
    position), identical in every process — so chaos can verify that a
    failed-over or interrupted stream delivered EXACTLY a prefix of
    the true sequence (any replayed or skipped token breaks the
    position-dependent pattern)."""
    s = sum(int(x) for x in prompt_ids) % 9973
    return (7919 * s + 131 * int(i) + 17 * len(prompt_ids)) % 997


class _ToyHandle:
    """Duck-type of engine.RequestHandle: token queue + completion."""

    def __init__(self, request_id):
        self.request_id = request_id
        self.tenant_id = None
        self.done = threading.Event()
        self.finish_reason = None
        self.cancelled = False
        self.cache_state = "miss"   # no prefix cache in the toy engine
        self.tokens = []
        self._prompt = []
        self._q = queue.Queue()

    def _finish(self, reason):
        if self.done.is_set():
            return
        self.finish_reason = reason
        self.done.set()
        self._q.put(None)

    def stream(self, timeout=120.0):
        while True:
            tok = self._q.get(timeout=timeout)  # queue.Empty → caller
            if tok is None:
                return
            yield tok

    def result(self, timeout=300.0):
        if not self.done.wait(timeout=timeout):
            raise TimeoutError(f"toy request {self.request_id} not done")
        return np.asarray(list(self._prompt) + list(self.tokens),
                          np.int32)


class _ToyConfig:
    def __init__(self, max_slots):
        self.max_slots = int(max_slots)


class ToyEngine:
    """Deterministic, model-free engine duck-type behind POST /generate:
    one daemon thread per sequence emits `toy_token(prompt, i)` every
    `token_time` seconds.  Exists so router/fleet failover semantics
    are provable in fast tier-1 tests and cross-process chaos without
    compiling a model; the real `inference.engine.InferenceEngine`
    drops in unchanged (`--kind gpt`)."""

    def __init__(self, max_slots=4, token_time=0.01):
        self.config = _ToyConfig(max_slots)
        self.token_time = float(token_time)
        self._lock = threading.Lock()
        self._handles = {}
        self._active = 0
        self._stopped = False
        # tenant metering parity with the real engine: the
        # toy fleet's chaos runs gate the conservation invariant, so
        # the toy engine must keep the same per-tenant decode books
        # (record_decode owns the engine.tokens increment)
        from ..observability import metrics as _metrics
        from ..observability import tenant_ledger as _tledger

        self.tenant_ledger = _tledger.TenantLedger() \
            if _tledger.enabled() and _metrics.enabled() else None

    def start(self):
        return self

    def stop(self, timeout=5.0):
        with self._lock:
            self._stopped = True
            handles = list(self._handles.values())
        for h in handles:
            h.cancelled = True
            h._finish("cancelled")

    def submit(self, input_ids, max_new_tokens=32, eos_token_id=None,
               request_id=None, tenant_id=None, priority_class=None,
               deadline=None, prebilled_tokens=0):
        # priority_class / deadline / prebilled_tokens are accepted for
        # signature parity with the real engine (serving passes them
        # through uniformly); the toy engine has no scheduler to
        # preempt or shed, so it honors only the billing marker —
        # chaos gates the conservation invariant against toy books too
        ids = [int(x) for x in np.asarray(input_ids).reshape(-1)]
        if not ids:
            raise ValueError("empty input_ids")
        h = _ToyHandle(request_id or uuid.uuid4().hex[:16])
        h.tenant_id = tenant_id
        h.priority_class = priority_class
        h._prompt = ids
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine stopped")
            self._handles[h.request_id] = h
            self._active += 1

        def _run():
            try:
                for i in range(int(max_new_tokens)):
                    if h.cancelled:
                        h._finish("cancelled")
                        return
                    if self.token_time:
                        time.sleep(self.token_time)
                    tok = toy_token(ids, i)
                    h.tokens.append(tok)
                    if i < int(prebilled_tokens):
                        pass  # resume verify token: billed by the
                        # replica that died, never twice
                    elif self.tenant_ledger is not None:
                        self.tenant_ledger.record_decode(tenant_id)
                    h._q.put(tok)
                    if eos_token_id is not None and tok == eos_token_id:
                        h._finish("eos")
                        return
                h._finish("length")
            finally:
                with self._lock:
                    self._active -= 1
                    self._handles.pop(h.request_id, None)

        threading.Thread(target=_run, daemon=True,
                         name=f"toy-seq-{h.request_id[:6]}").start()
        return h

    def cancel(self, request_id):
        with self._lock:
            h = self._handles.get(request_id)
        if h is None:
            return False
        h.cancelled = True
        h._finish("cancelled")
        return True

    def stats(self):
        with self._lock:
            n = self._active
        m = self.config.max_slots
        return {"running": n, "waiting": 0, "max_slots": m,
                "occupancy": n / m, "steps": 0, "pages": {}}


# ---------------------------------------------------------------------------
# the fleet supervisor
# ---------------------------------------------------------------------------

class _ReplicaHandle:
    """One supervised replica slot (rank is stable across relaunches)."""

    __slots__ = ("rank", "rid", "proc", "address", "announce",
                 "restarts", "drain_requested", "log_path", "removed")

    def __init__(self, rank):
        self.rank = int(rank)
        self.rid = f"r{rank}"
        self.proc = None
        self.address = None
        self.announce = None
        self.restarts = 0
        self.drain_requested = False
        self.log_path = None
        self.removed = False   # retired rank: exit is final, no relaunch


class ReplicaFleet:
    """Launch and supervise a replica fleet behind a `Router`.

    `start()` spawns the replicas, waits for each to announce its
    address, starts the router (synchronous first probe), and begins
    the monitor loop.  `stop()` drains the router, SIGTERMs every
    replica, and reaps them.  See the module docstring for semantics.
    """

    def __init__(self, num_replicas=None, kind="echo", model_path=None,
                 router=None, router_kwargs=None, service_time=0.0,
                 token_time=0.01, max_slots=4, request_timeout=30.0,
                 heartbeat=True, heartbeat_interval=0.4,
                 heartbeat_ttl=1.6, max_restarts=3,
                 monitor_interval=0.15, launch_timeout=60.0,
                 workdir=None, replica_env=None, spawner=None,
                 telemetry_dir=None, device=None):
        if num_replicas is None:
            num_replicas = _env_num("PADDLE_TPU_FLEET_REPLICAS", 2, int)
        self.num_replicas = max(1, int(num_replicas))
        self.kind = str(kind)
        self.model_path = model_path
        self.service_time = float(service_time)
        self.token_time = float(token_time)
        self.max_slots = int(max_slots)
        self.request_timeout = float(request_timeout)
        self.heartbeat = bool(heartbeat)
        self.heartbeat_interval = float(heartbeat_interval)
        self.heartbeat_ttl = float(heartbeat_ttl)
        self.max_restarts = int(max_restarts)
        self.monitor_interval = float(monitor_interval)
        self.launch_timeout = float(launch_timeout)
        self.workdir = workdir
        self.replica_env = dict(replica_env or {})
        self.telemetry_dir = telemetry_dir
        # the device of a `gpt` replica's engine or a `model` replica's
        # predictor (the other kinds run no model): cuda unless the
        # caller names another
        self.device = "cuda" if device is None else str(device)
        if self.kind in ("gpt", "model"):
            from ..core.device import resolve_device

            resolve_device(self.device)
        self._spawner = spawner or self._spawn_subprocess
        self.job_id = f"fleet-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self._handles = {r: _ReplicaHandle(r)
                         for r in range(self.num_replicas)}
        self._next_rank = self.num_replicas  # dynamic growth cursor
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._monitor_thread = None
        self.store = None
        self._store_is_master = False
        self._store_addr = None
        self._elastic = None
        self.events = []  # ordered lifecycle log (tests assert on it)
        # spawn-to-routable phase records: the supervisor
        # stamps what only it can see (Popen, announce file observed);
        # the router stamps first_probe_up/first_routable_request and
        # attaches each replica's own ledger record at first probe-up
        self.lifecycle = _lifecycle.FleetLifecycle()
        if router is not None:
            self.router = router
        else:
            from .router import Router

            kw = dict(router_kwargs or {})
            kw.setdefault("request_timeout", self.request_timeout)
            self.router = Router(**kw)
        self.router.lifecycle = self.lifecycle

    # --- heartbeat plumbing (fleet/elastic.py reuse) ----------------------
    def _start_store(self):  # pt-lint: ok[PT503] (startup phase: runs once from start() before the monitor/relaunch threads exist; the heartbeats escape on the last line is the publish barrier)
        """TCPStore master for the heartbeat registry; replicas beat
        through their own `ElasticManager`.  Heartbeats are an extra
        liveness signal, not a hard dependency — when the native store
        cannot start (port exhaustion, missing lib) the fleet degrades
        to process-exit + readiness-probe liveness only."""
        if not self.heartbeat:
            return
        try:
            from ..distributed.fleet.elastic import ElasticManager
            from ..distributed.store import TCPStore
        except Exception as e:  # pt-lint: ok[PT005]
            self._event("store_unavailable", error=type(e).__name__)
            return  # degrade: no heartbeat plane (reason logged above)
        base = 19000 + (os.getpid() * 7) % 20000
        for k in range(16):
            port = base + k * 13
            try:
                self.store = TCPStore("127.0.0.1", port, is_master=True)
                self._store_is_master = True
                self._store_addr = f"127.0.0.1:{port}"
                break
            except Exception:  # pt-lint: ok[PT005]
                continue       # port taken: probe the next candidate
        if self.store is None:
            self._event("store_unavailable", error="no_free_port")
            return
        self._elastic = ElasticManager(
            store=self.store, job_id=self.job_id,
            np_range=str(self.num_replicas),
            heartbeat_interval=self.heartbeat_interval,
            heartbeat_ttl=self.heartbeat_ttl)
        self.router.heartbeats = self._alive_replicas

    def _alive_replicas(self):
        """Replica ids with fresh heartbeats — the router's heartbeat
        source.  Reads the same `elastic/<job>/hb/<rank>` keys the
        replicas' ElasticManagers write, with a short per-key timeout
        so a missing rank costs milliseconds, not the elastic default
        blocking get."""
        alive = set()
        if self.store is None or self._elastic is None:
            return alive
        now = time.time()
        with self._lock:
            ranks = list(self._handles)  # live membership, not the
            # __init__ roster: a dynamically-added rank must be able to
            # beat, a removed rank must stop being asked after
        for r in ranks:
            key = self._elastic._hb_key(r)
            try:
                if not self.store.check(key):
                    continue
                ts = float(self.store.get(key, timeout=0.1))
            except Exception:  # pt-lint: ok[PT005]
                continue       # absent/failed key IS the miss signal
            if now - ts <= self.heartbeat_ttl:
                alive.add(f"r{r}")
        return alive

    # --- spawning ---------------------------------------------------------
    def _replica_cmd(self, handle):
        cmd = [sys.executable, "-m", "paddle_tpu_torch.inference.fleet",
               "--replica", "--rank", str(handle.rank),
               "--kind", self.kind, "--device", self.device,
               "--announce", handle.announce,
               "--job-id", self.job_id,
               "--service-time", str(self.service_time),
               "--token-time", str(self.token_time),
               "--max-slots", str(self.max_slots),
               "--request-timeout", str(self.request_timeout),
               "--heartbeat-interval", str(self.heartbeat_interval),
               "--heartbeat-ttl", str(self.heartbeat_ttl)]
        if self._store_addr:
            cmd += ["--store", self._store_addr]
        if self.model_path:
            cmd += ["--model-path", str(self.model_path)]
        return cmd

    def _replica_environ(self, handle):
        env = dict(os.environ)
        env.update(self.replica_env)
        env["PADDLE_TRAINER_ID"] = str(handle.rank)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + \
            env.get("PYTHONPATH", "")
        if self.telemetry_dir:
            env["PADDLE_TPU_TELEMETRY_DIR"] = str(self.telemetry_dir)
        return env

    def _spawn_subprocess(self, handle, cmd, env):
        log = open(handle.log_path, "ab")
        try:
            return subprocess.Popen(cmd, env=env, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    cwd=_REPO_ROOT)
        finally:
            log.close()  # the child holds its own fd

    def _launch(self, handle):
        """Spawn one replica process.  The fork+exec runs OUTSIDE the
        fleet lock (it costs tens of milliseconds — holding the lock
        across it stalls the monitor sweep and every router membership
        change behind process creation), but the anti-orphan invariant
        vs `stop()` still holds: the proc is installed under the lock
        with a stopping re-check, and when stop() won the race — its
        sweep snapshot cannot have seen this proc — the spawner kills
        its own child right here.  Either the sweep owns the process or
        we do; there is no window where nobody does.
        Returns False when stopping."""
        handle.announce = os.path.join(
            self.workdir, f"replica_{handle.rank}"
                          f"_{handle.restarts}.addr")
        handle.log_path = os.path.join(
            self.workdir, f"replica_{handle.rank}.log")
        handle.address = None
        handle.drain_requested = False
        cmd = self._replica_cmd(handle)
        env = self._replica_environ(handle)
        # open the spawn record + pass the supervisor's wall anchor to
        # the child (the cross-process half of the clock-skew join: the
        # child back-dates proc_spawn by the wall delta so its imports
        # phase covers fork + interpreter start)
        spawn_wall = self.lifecycle.spawn(handle.rid, rank=handle.rank)
        env["PADDLE_TPU_SPAWN_WALL"] = f"{spawn_wall:.6f}"
        with self._lock:
            if self._stopping.is_set() or handle.removed:
                return False  # stopping, or the rank was retired while
                # a relaunch was in flight — don't even spawn
        proc = self._spawner(handle, cmd, env)
        with self._lock:
            if not (self._stopping.is_set() or handle.removed):
                handle.proc = proc
                proc = None  # installed: stop()/remove's sweep owns it
        if proc is not None:
            # stop() or remove_replica() raced the spawn: their sweeps
            # never saw this proc, so reaping it is OUR job
            try:
                proc.kill()
                proc.wait(timeout=5.0)
            except Exception:  # pt-lint: ok[PT005]
                pass           # already dead / unkillable zombie —
                # nothing more a supervisor can do with it
            return False
        self._event("replica_spawned", rank=handle.rank,
                    restarts=handle.restarts)
        return True

    def _await_announce(self, handle, timeout=None):
        """Block until the replica writes its address file (atomic
        rename), or it dies, or the timeout lapses.  Returns the
        address or None."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.launch_timeout)
        while time.monotonic() < deadline:
            if self._stopping.is_set():
                return None  # stop() owns teardown from here
            if os.path.exists(handle.announce):
                try:
                    with open(handle.announce) as f:
                        info = json.load(f)
                    handle.address = info["address"]
                    self.lifecycle.stamp(handle.rid, "announce")
                    return handle.address
                except (ValueError, KeyError, OSError):
                    pass  # torn read mid-rename: retry next tick
            if handle.proc is not None and \
                    handle.proc.poll() is not None:
                return None  # died during startup
            time.sleep(0.02)
        return None

    # --- lifecycle --------------------------------------------------------
    def start(self, wait_ready=True, ready_timeout=None):
        # pt-lint: ok[PT503] (startup phase: workdir is pinned before any replica or monitor thread exists, and never rebound after)
        self.workdir = self.workdir or tempfile.mkdtemp(
            prefix="paddle_tpu_fleet_")
        os.makedirs(self.workdir, exist_ok=True)
        self._start_store()
        with self._lock:
            handles = list(self._handles.values())
        for handle in handles:
            self._launch(handle)
        for handle in handles:
            addr = self._await_announce(handle)
            if addr is None:
                raise RuntimeError(
                    f"replica {handle.rid} failed to start "
                    f"(see {handle.log_path})")
            self.router.add_replica(handle.rid, addr)
        self.router.start()
        if wait_ready:
            self.wait_ready(timeout=ready_timeout)
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True,
            name="paddle-tpu-fleet-monitor")
        self._monitor_thread.start()
        return self

    def wait_ready(self, n=None, timeout=None):
        """Block until `n` (default: all) replicas are routable."""
        want = self.num_replicas if n is None else int(n)
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.launch_timeout)
        while time.monotonic() < deadline:
            if self.router.routable_count() >= want:
                return True
            time.sleep(0.05)
        return self.router.routable_count() >= want

    def _monitor(self):
        """Reap loop.  Deliberately non-blocking: deaths are booked
        with the router IMMEDIATELY; the relaunch (whose announce wait
        can take seconds) runs on a helper thread per replica, so one
        wedged relaunch never delays detecting another replica's
        death."""
        relaunching: set = set()
        while not self._stopping.wait(self.monitor_interval):
            with self._lock:
                sweep = list(self._handles.values())
            # the sweep runs over a snapshot: membership may change
            # under it (autoscaler add/remove).  A handle popped
            # mid-sweep has proc=None (skip); a handle added mid-sweep
            # is picked up next tick; a REMOVED rank's exit is final —
            # relaunching it would resurrect what the autoscaler
            # deliberately retired.
            for handle in sweep:
                proc = handle.proc
                if proc is None or handle.rank in relaunching:
                    continue
                rc = proc.poll()
                if rc is None:
                    continue
                # the process is gone: tell the router NOW (faster
                # than aging out K heartbeats), then heal
                self._event("replica_exit", rank=handle.rank, rc=rc,
                            drained=handle.drain_requested)
                self.router.note_replica_down(handle.rid)
                handle.proc = None
                if self._stopping.is_set() or handle.removed:
                    continue
                if handle.restarts >= self.max_restarts:
                    # out of restarts: RETIRE the rank instead of
                    # keeping a corpse on the roster — a dead handle
                    # would inflate replica_count() forever, blocking
                    # the autoscaler's max bound with capacity that
                    # does not exist (it can now add a fresh rank)
                    self._event("replica_abandoned", rank=handle.rank)
                    with self._lock:
                        self._handles.pop(handle.rank, None)
                    self.router.remove_replica(handle.rid)
                    continue
                handle.restarts += 1
                relaunching.add(handle.rank)
                threading.Thread(
                    target=self._relaunch,
                    args=(handle, relaunching.discard), daemon=True,
                    name=f"fleet-relaunch-r{handle.rank}").start()

    def _relaunch(self, handle, done_cb):
        try:
            if not self._launch(handle):
                return  # stopping: stop() owns teardown
            addr = self._await_announce(handle)
            if addr is not None:
                self.router.update_replica(handle.rid, addr)
                self._event("replica_relaunched", rank=handle.rank,
                            address=addr)
            else:
                self._event("replica_relaunch_failed",
                            rank=handle.rank)
        finally:
            done_cb(handle.rank)

    # --- dynamic membership ------
    def replica_count(self):
        """Live fleet size (supervised ranks, whatever their state)."""
        with self._lock:
            return len(self._handles)

    def replica_ranks(self):
        with self._lock:
            return sorted(self._handles)

    def observed_spawn_ms(self):
        """Median observed spawn -> first_probe_up wall over recent
        spawns — what the autoscaler's predictive signal is
        actually buying.  None before any spawn completed."""
        return self.lifecycle.observed_spawn_ms()

    def add_replica(self, timeout=None):
        """Grow the fleet by one replica: fresh rank, spawn, await the
        announce file, register with the router (readiness-gated into
        rotation by the probe loop, like any launch).  Returns the new
        rank, or None when stopping or the launch failed — the failed
        handle leaves the table either way, so a flaky spawn cannot
        leave a rank the monitor supervises but the router never saw."""
        with self._lock:
            if self._stopping.is_set():
                return None
            rank = self._next_rank
            self._next_rank += 1
            handle = _ReplicaHandle(rank)
            self._handles[rank] = handle
        if not self._launch(handle):
            with self._lock:
                self._handles.pop(rank, None)
            return None
        addr = self._await_announce(handle, timeout=timeout)
        if addr is None:
            self._event("replica_add_failed", rank=rank)
            with self._lock:
                # removed BEFORE the pop: a monitor sweep holding this
                # handle in its snapshot must see the retirement, or it
                # would relaunch the dead rank into a process no sweep
                # ever kills and a router entry no handle supervises
                handle.removed = True
                proc = handle.proc
                self._handles.pop(rank, None)
            if proc is not None:
                try:
                    proc.kill()
                    proc.wait(timeout=2.0)
                except Exception:  # pt-lint: ok[PT005]
                    pass  # already gone — which is all we needed
            return None
        self.router.add_replica(handle.rid, addr)
        self._event("replica_added", rank=rank, address=addr)
        return rank

    def remove_replica(self, rank, grace=5.0, exit_timeout=10.0):
        """Shrink the fleet by one replica through the zero-loss drain
        protocol (rotation out → router in-flight to zero → SIGTERM →
        PreemptionGuard drain → exit 0), then retire the rank: the
        monitor never relaunches it and the router forgets it.  Returns
        the replica's exit code (0 for a clean drain), True when the
        rank retired but its process was already gone (nothing to
        reap), or None when the rank is unknown — callers branch on
        `is None` to tell "removed nothing" from "removed".  A process
        that outlives `exit_timeout` is killed — the rank retires
        either way."""
        with self._lock:
            handle = self._handles.get(int(rank))
            if handle is None:
                return None
            handle.removed = True  # from here the exit is final
            # capture the process HERE, in the same critical section:
            # after the drain below the monitor may have reaped the
            # exit and nulled handle.proc, and reading it then would
            # lose the exit code a clean drain must report (rc=0)
            proc = handle.proc
        self.drain_replica(rank, grace=grace)
        rc = None
        if proc is not None:
            try:
                rc = proc.wait(timeout=exit_timeout)
            except Exception:  # pt-lint: ok[PT005]
                try:           # (drain overran its grace: hard stop —
                    proc.kill()      # the rank is leaving regardless)
                    rc = proc.wait(timeout=2.0)
                except Exception:  # pt-lint: ok[PT005]
                    pass           # unkillable == already a zombie
        with self._lock:
            handle.proc = None
            self._handles.pop(int(rank), None)
        self.router.remove_replica(handle.rid)
        self._event("replica_removed", rank=handle.rank, rc=rc)
        return rc if proc is not None else True

    def drain_replica(self, rank, grace=5.0):
        """Deliberate drain of one replica, in the safe order: router
        rotation OUT first, router-side in-flight toward it to zero
        (bounded by `grace`), THEN SIGTERM — the replica's
        PreemptionGuard handles the rest (finish in-flight, exit 0).
        The monitor relaunches it afterward (capacity heals)."""
        with self._lock:
            handle = self._handles.get(int(rank))
        if handle is None:
            return False  # retired/unknown rank: a drain is a no-op,
            # not a KeyError (ranks can now leave the table at runtime)
        self._event("drain_mark", rank=handle.rank)
        self.router.mark_draining(handle.rid)
        deadline = time.monotonic() + float(grace)
        while self.router.inflight_to(handle.rid) > 0 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        handle.drain_requested = True
        self._event("drain_sigterm", rank=handle.rank)
        if handle.proc is not None:
            try:
                handle.proc.send_signal(signal.SIGTERM)
            except (ProcessLookupError, OSError):  # pt-lint: ok[PT005]
                pass  # already gone: the monitor will book the exit
        return True

    def kill_replica(self, rank):
        """Hard kill (SIGKILL) — the chaos path.  No drain, no mercy;
        the router's failover owns the consequences."""
        with self._lock:
            handle = self._handles.get(int(rank))
        if handle is None:
            return False  # already retired: as dead as kill would
            # have made it
        self._event("kill", rank=handle.rank)
        if handle.proc is not None:
            try:
                handle.proc.kill()
            except (ProcessLookupError, OSError):  # pt-lint: ok[PT005]
                pass  # already dead — which is what we wanted
        return True

    def stop(self, timeout=10.0):
        self._stopping.set()
        with self._lock:
            # barrier: an in-flight _launch finishes its spawn before
            # the sweep below runs; later ones refuse (see _launch).
            # The sweep itself runs over a SNAPSHOT: membership can
            # shrink concurrently (an autoscaler remove_replica mid
            # stop pops its handle), and iterating the live dict would
            # either skip a replica or die on the mutation — either way
            # an orphan.  The snapshot covers every rank alive at the
            # barrier, including dynamically-added ones.
            handles = list(self._handles.values())
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=2.0)
        for handle in handles:
            if handle.proc is not None and handle.proc.poll() is None:
                try:
                    handle.proc.send_signal(signal.SIGTERM)
                except (ProcessLookupError, OSError):  # pt-lint: ok[PT005]
                    pass  # raced its own exit
        deadline = time.monotonic() + float(timeout)
        for handle in handles:
            if handle.proc is None:
                continue
            remaining = max(0.1, deadline - time.monotonic())
            try:
                handle.proc.wait(timeout=remaining)
            except Exception:  # pt-lint: ok[PT005]
                try:           # (drain overran its grace: hard stop —
                    handle.proc.kill()   # stop() must return)
                    handle.proc.wait(timeout=2.0)
                except Exception:  # pt-lint: ok[PT005]
                    pass           # unkillable == already a zombie
        self.router.shutdown()
        if self._elastic is not None:
            self._elastic.stop()
        self.store = None
        return True

    def _event(self, kind, **data):
        row = dict(data, kind=kind, t=time.time())
        with self._lock:
            self.events.append(row)
        try:
            from ..observability import flight as _flight

            _flight.record(f"fleet.{kind}", **data)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: supervision
            # must supervise even when telemetry is broken)

    def describe(self):
        with self._lock:
            handles = {
                h.rid: {"rank": h.rank, "address": h.address,
                        "restarts": h.restarts,
                        "alive": h.proc is not None
                        and h.proc.poll() is None}
                for h in self._handles.values()}
        return {"job_id": self.job_id, "replicas": handles,
                "router": self.router.replica_summary()}


# ---------------------------------------------------------------------------
# replica entry point (python -m paddle_tpu_torch.inference.fleet --replica)
# ---------------------------------------------------------------------------

def _build_gpt_engine(seed=0, max_slots=4, device=None):
    """A real continuous-batching engine over a small seeded GPT — the
    same model every replica builds (same seed → same weights → greedy
    decode is replica-independent, so failover changes nothing about
    the tokens a client sees), on `device` (cuda when None)."""
    from ..core import rng
    from ..models.gpt import GPTConfig, GPTForCausalLM
    from .engine import EngineConfig, InferenceEngine

    rng.seed(seed)
    cfg = GPTConfig(vocab_size=256, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=96)
    model = GPTForCausalLM(cfg, device=device, seed=seed)
    model.eval()
    return InferenceEngine(model, EngineConfig(
        page_size=8, max_slots=max_slots, decode_chunk=2,
        max_seq_len=96))


def _replica_parser():
    import argparse

    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.inference.fleet")
    ap.add_argument("--replica", action="store_true", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--kind", default="echo",
                    choices=("echo", "toy", "gpt", "model"))
    # a gpt or model replica's device: the card unless the caller names
    # another
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--announce", required=True)
    ap.add_argument("--job-id", default="fleet")
    ap.add_argument("--store", default=None)
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--service-time", type=float, default=0.0)
    ap.add_argument("--token-time", type=float, default=0.01)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--request-timeout", type=float, default=30.0)
    ap.add_argument("--heartbeat-interval", type=float, default=0.4)
    ap.add_argument("--heartbeat-ttl", type=float, default=1.6)
    return ap


def _replica_main(argv=None):
    args = _replica_parser().parse_args(argv)

    from .. import observability as obs
    from ..resilience import faults as _faults
    from .serving import InferenceServer

    obs.attach(crash_hook=False)
    # lifecycle: anchor at the supervisor's Popen wall time
    # (PADDLE_TPU_SPAWN_WALL) so the imports phase covers fork +
    # interpreter start + the imports above, then stamp each startup
    # phase on THIS process's monotonic clock
    led = obs.lifecycle.get_ledger()
    led.begin(spawn_wall=os.environ.get("PADDLE_TPU_SPAWN_WALL"))
    led.stamp("imports")
    predictor = engine = None
    if args.kind in ("echo", "toy"):
        predictor = EchoPredictor(service_time=args.service_time)
    if args.kind == "toy":
        engine = ToyEngine(max_slots=args.max_slots,
                           token_time=args.token_time)
    elif args.kind == "gpt":
        engine = _build_gpt_engine(seed=0, max_slots=args.max_slots,
                                   device=args.device)
    elif args.kind == "model":
        from .serving import saved_model_predictor

        predictor = saved_model_predictor(args.model_path, args.device)
    led.stamp("weight_load")

    srv = InferenceServer(
        predictor=predictor, engine=engine,
        request_timeout=args.request_timeout)
    guard = srv.install_preemption()

    elastic = None
    if args.store:
        try:
            from ..distributed.fleet.elastic import ElasticManager
            from ..distributed.store import TCPStore

            host, port = args.store.rsplit(":", 1)
            store = TCPStore(host, int(port), is_master=False)
            elastic = ElasticManager(
                store=store, job_id=args.job_id,
                np_range=str(args.rank + 1),
                heartbeat_interval=args.heartbeat_interval,
                heartbeat_ttl=args.heartbeat_ttl)
            elastic.rank = args.rank
            elastic.register()
        except Exception as e:
            # a replica without a heartbeat plane still serves: the
            # router falls back to probe liveness for it.  Say so.
            print(f"replica {args.rank}: heartbeat disabled "
                  f"({type(e).__name__}: {e})", file=sys.stderr)
            elastic = None

    exporter = None
    if os.environ.get("PADDLE_TPU_TELEMETRY_DIR"):
        from ..observability.export import TelemetryExporter

        exporter = TelemetryExporter(
            slo=srv.slo.report, rank=args.rank,
            # per-tenant ledger: each replica dumps its own
            # book; telemetry_agg merges them into the fleet rollup
            tenants=(srv.tenant_ledger.snapshot
                     if srv.tenant_ledger is not None else None),
            # per-request timelines: real engines expose
            # them; toy duck-types simply don't ship the key
            timelines=getattr(srv.engine, "recent_timelines", None),
            # lifecycle record: each dump carries this
            # replica's spawn-phase story; full state, last dump wins
            lifecycle=led.record).start()

    # warm up BEFORE serving and announcing: a tiny generate, run inline
    # on this thread, builds the kernels and captures the engine's first
    # prefill and decode programs, so "routable" means "warm" — the cost
    # lands in the warmup phase (each graph timed under its JAX label by
    # observability.capture_cost) instead of the first client request.
    # A failure raises: the replica exits non-zero and the supervisor
    # sees a crash.  PADDLE_TPU_REPLICA_WARMUP=0 announces unwarmed.
    warm = os.environ.get("PADDLE_TPU_REPLICA_WARMUP", "1") != "0"
    if warm and args.kind == "gpt" and engine is not None:
        engine.generate([np.arange(1, 5, dtype=np.int32)],
                        max_new_tokens=2)
    if warm and args.kind == "model":
        import torch

        predictor.run([torch.zeros([1 if d == -1 else d for d in shape],
                                   dtype=dtype)
                       for shape, dtype in predictor.input_specs().values()])
    if args.kind in ("gpt", "model"):
        # the counts /debug/telemetry reports start at announce: what
        # is launched after it, was launched for the replica's clients
        from ..ops import kernels as _kernels

        _kernels.reset_launches()
    if args.kind == "gpt":
        engine.prefill_count = engine.decode_steps = 0
    srv.start()
    led.stamp("warmup")
    tmp = args.announce + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"address": srv.address, "pid": os.getpid(),
                   "rank": args.rank}, f)
    os.replace(tmp, args.announce)  # atomic: no torn reads
    led.stamp("announce")

    try:
        while not guard.preempted:
            # the chaos hook: kind="error" → crash (non-zero exit);
            # any other kind → simulated kill -9
            try:
                act = _faults.fire("replica.crash", rank=args.rank)
            except _faults.InjectedFault:
                sys.exit(1)
            if act is not None:
                os._exit(137)
            guard.wait(timeout=0.25)
    finally:
        srv.shutdown()
        if elastic is not None:
            elastic.stop()
        if exporter is not None:
            exporter.stop()
    print(f"replica {args.rank} drained ({guard.reason})", flush=True)


if __name__ == "__main__":
    _replica_main()
