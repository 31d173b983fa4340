"""Admission-aware HTTP router over a fleet of InferenceServer replicas.

One process cannot serve millions of users: the continuous-batching
engine behind a single `InferenceServer` is one preemption away from
taking the whole serving plane down.  The `Router` is the deployment
story (ROADMAP item 5): N replicas — typically launched and supervised
by `inference.fleet.ReplicaFleet`, one per device — behind a thin
stdlib HTTP proxy that routes on the *admission signals the replicas
already export* and survives replicas dying under it.

Routing (docs/SERVING.md):
  * **least-loaded pick** — a probe loop polls every replica's
    `GET /ready` (which now carries `inflight`/`queued`/
    `admission_limit` and the engine's `batch_occupancy`/
    `waiting_sequences`); `/predict` goes to the
    replica with the lowest (inflight+queued)/limit, `/generate` to the
    emptiest decode engine.  Router-side in-flight counts are added so
    bursts between probes don't herd onto one replica.
  * **failover** — a replica that dies mid-request (connection error),
    trips its `CircuitBreaker` (resilience.retry reuse), or misses
    `heartbeat_miss_k` heartbeats is skipped/ejected; in-flight
    non-streamed requests transparently retry on a healthy replica
    under the SAME `X-Request-Id`.  Streamed
    `/generate` requests fail over freely while ZERO tokens have been
    delivered; once tokens ARE delivered, a replica loss triggers a
    deterministic mid-stream RESUME: the router resubmits
    `prompt + delivered[:-1]` to another replica (valid by the greedy
    determinism contract), requires the leg's first token to reproduce
    `delivered[-1]` (divergence check, token swallowed, billed
    nowhere), then keeps streaming — zero replay, same request id,
    `"resumed": n` on the final record.  Resume is bounded
    (`stream_resume_max` legs), deadline-aware and class-gated; any
    refusal or divergence falls back LOUDLY to one clean `interrupted`
    record carrying the resumable `output_ids` prefix — never replayed
    tokens (`InferenceClient` raises `StreamInterrupted`, or resumes
    client-side itself with `resume=True`).
  * **drain-aware** — `mark_draining()` stops routing BEFORE the
    replica's own drain begins (the fleet calls it ahead of SIGTERM, so
    clients never see a thundering herd of 503s); a replica whose
    readiness reports `draining` is likewise taken out of rotation.
  * **edge admission** — ONE fleet-level `AdmissionController` (its
    capacity tracks the live sum of routable replica limits via
    `set_capacity`) sheds once, at the edge, with an honest
    `Retry-After`; `no_replicas` sheds map to 503.

Telemetry: `router.replicas{state=up|draining|ejected|down}` and
`router.capacity{endpoint}` gauges (live routable capacity),
`router.failovers` / `router.ejections` / `router.readmissions` and
`router.requests{endpoint,status}` counters (attach() schema),
`router.stream_resumes{outcome=ok|diverged|exhausted}` counters with
the `router.resume_gap_ms` histogram attributing the client-visible
resume seam, and `router.request`/`router.forward` spans carrying
request identity.
The router also keeps a fleet-level `SLOTracker` (`router.slo`) fed
from every finished edge request — sheds and unsaved failures burn
budget here even when each replica's own ledger is clean; its burn
rate is the `inference.autoscaler.Autoscaler`'s primary scale signal.
Fault points: `router.forward` fires per forward attempt,
`router.stream_read` per streamed line read (severs a stream
mid-flight deterministically), `router.resume_verify` at the
divergence check (forces the loud fallback) — all chaos-drivable.

Prefix-affinity routing: /generate
requests may carry an `X-Prefix-Fingerprint` header (the client's
cheap hash of the first N page-aligned prompt tokens; the router
computes its own from the parsed prompt when absent).  A bounded LRU
fingerprint->replica map remembers where each prefix last landed, and
the pick PREFERS the affine replica when its load is within
`affinity_slack` of the least-loaded candidate — repeat tenants land
where their prefix cache lives, without ever overriding drain/eject
state (affine picks are drawn from the routable set only) and without
letting affinity pile load on one replica (the slack bound).  The
fingerprint is routing metadata ONLY — the engine's radix index
matches real token values, so a poisoned header degrades to a cache
miss, never a wrong-token stream.

Env knobs (read when the matching ctor arg is None):
  PADDLE_TPU_HEARTBEAT_MISS_K   probes/beats missed before ejection (3)
  PADDLE_TPU_FAILOVER_RETRIES   extra replicas tried per request    (2)
  PADDLE_TPU_ROUTER_AFFINITY_SLACK  affine-pick load slack       (0.25)
  PADDLE_TPU_STREAM_RESUME_MAX      mid-stream resume legs/stream  (2)
  PADDLE_TPU_STREAM_RESUME_CLASSES  classes served by resume     (all)

Transport and clock are injectable — unit tests drive the whole state
machine with fake replicas and no sockets (tests/test_router.py).
"""
from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..observability import metrics as _metrics
from ..observability import request_trace as _rtrace
from ..observability import tenant_ledger as _tledger
from ..observability import timeseries as _ts
from ..observability import trace as _trace
from ..observability.slo import SLOTracker
from ..resilience.overload import AdmissionController, ShedError, _env_num
from ..resilience.retry import CircuitBreaker, CircuitOpenError
from . import qos as _qos
from .serving import _retry_after_header

__all__ = ["Router", "HTTPTransport", "ReplicaUnreachable"]

_REPLICA_STATES = ("up", "draining", "ejected", "down")

# the router's declared timeseries set: edge pressure and
# fleet capacity — the queue-growth derivatives the autoscaler's
# predictive signal is made of, visible on GET /debug/timeseries.
# Bare names sum their label variants (right for counters and for
# capacity); replica-count gauges are watched at their EXACT labeled
# keys — summing target+actual or up+down would double-count.
ROUTER_SERIES = (
    "router.requests", "router.capacity",
    "router.replicas{state=up}", "router.failovers",
    "router.stream_resumes",
    "serving.inflight", "serving.queue_depth",
    "autoscaler.replicas{state=actual}",
)


class ReplicaUnreachable(ConnectionError):
    """Transport-level failure talking to a replica (refused, reset,
    premature EOF): the failover trigger, as opposed to an HTTP status
    the replica deliberately sent."""


class _HTTPStream:
    """One open streamed response off a replica: status + headers up
    front, then an ndjson line iterator.  `close()` is idempotent and
    tears the TCP connection down (a client abandoning the proxy stream
    propagates as a dead socket the replica can notice)."""

    def __init__(self, conn, resp):
        self._conn = conn
        self._resp = resp
        self.status = resp.status
        self.headers = dict(resp.headers)

    def lines(self):
        for line in self._resp:
            yield line

    def read_body(self):
        return self._resp.read()

    def close(self):
        try:
            self._conn.close()
        except Exception:  # pt-lint: ok[PT005]
            pass           # (teardown best-effort: the socket may
            # already be gone — that is often WHY we are closing)


class HTTPTransport:
    """Default transport: stdlib http.client.  Connection-level
    failures (refused/reset/timeout on connect, dead socket mid-read)
    raise `ReplicaUnreachable`; HTTP statuses — including 4xx/5xx — are
    returned, not raised (the router decides what they mean)."""

    def _connect(self, address, timeout):
        u = urllib.parse.urlparse(address)
        return http.client.HTTPConnection(u.hostname, u.port,
                                          timeout=timeout)

    def request(self, address, method, path, body=None, headers=None,
                timeout=30.0):
        """Buffered exchange: returns (status, headers dict, body bytes)."""
        conn = self._connect(address, timeout)
        try:
            conn.request(method, path, body=body,
                         headers=dict(headers or {}))
            resp = conn.getresponse()
            return resp.status, dict(resp.headers), resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise ReplicaUnreachable(
                f"{address}{path}: {type(e).__name__}: {e}") from e
        finally:
            conn.close()

    def stream(self, address, path, body, headers=None, timeout=30.0):
        """Open a streamed POST; returns an `_HTTPStream` (caller owns
        `close()`).  Only the CONNECT + status-line phase raises
        `ReplicaUnreachable` here — mid-stream failures surface from
        the line iterator as OSError/HTTPException for the caller to
        classify against how much was already delivered."""
        conn = self._connect(address, timeout)
        try:
            conn.request("POST", path, body=body,
                         headers=dict(headers or {}))
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise ReplicaUnreachable(
                f"{address}{path}: {type(e).__name__}: {e}") from e
        return _HTTPStream(conn, resp)


class _Replica:
    """Router-side view of one replica.  All mutable fields are guarded
    by the Router's `_lock` (single coarse lock: the table is small and
    every transition must be atomic against the probe loop)."""

    __slots__ = ("id", "address", "breaker", "state", "signals",
                 "missed_heartbeats", "probe_failures", "inflight",
                 "generation", "draining_requested", "ever_up",
                 "ever_beat", "ever_forwarded")

    def __init__(self, rid, address, breaker):
        self.id = str(rid)
        self.address = str(address)
        self.breaker = breaker
        self.state = "down"          # probe promotes to "up"
        self.signals = {}            # last /ready payload
        self.missed_heartbeats = 0
        self.probe_failures = 0
        self.inflight = {"predict": 0, "generate": 0}
        self.generation = 0
        self.draining_requested = False
        self.ever_up = False         # first admission ≠ re-admission
        self.ever_beat = False       # heartbeats govern only after one
        self.ever_forwarded = False  # lifecycle first_routable_request

    def view(self):  # pt-lint: ok[PT102] (caller holds Router._lock)
        sig = self.signals
        return {
            "id": self.id, "address": self.address, "state": self.state,
            "breaker": self.breaker.state,
            "missed_heartbeats": self.missed_heartbeats,
            "probe_failures": self.probe_failures,
            "inflight": dict(self.inflight),
            "generation": self.generation,
            "signals": {k: sig.get(k) for k in
                        ("inflight", "queued", "admission_limit",
                         "engine") if k in sig},
        }


class Router:
    """Admission-aware reverse proxy over a replica fleet.  See the
    module docstring for semantics; `start()` returns immediately
    (daemon threads: HTTP accept loop + readiness/heartbeat probe
    loop), `shutdown()` drains the edge controller and closes the
    socket — replica lifecycle belongs to `ReplicaFleet`, not here."""

    # bounded fingerprint->replica map: enough for a large tenant
    # population, small enough that a hostile client cannot balloon
    # router memory by spraying fingerprints
    AFFINITY_CAP = 4096

    def __init__(self, host="127.0.0.1", port=0, replicas=None,
                 heartbeat_miss_k=None, failover_retries=None,
                 probe_interval=0.25, request_timeout=30.0,
                 max_inflight=None, queue_depth=None, transport=None,
                 heartbeats=None, clock=time.monotonic,
                 breaker_threshold=3, breaker_reset=2.0,
                 affinity_slack=None, stream_resume_max=None,
                 stream_resume_classes=None):
        if heartbeat_miss_k is None:
            heartbeat_miss_k = _env_num("PADDLE_TPU_HEARTBEAT_MISS_K",
                                        3, int)
        if failover_retries is None:
            failover_retries = _env_num("PADDLE_TPU_FAILOVER_RETRIES",
                                        2, int)
        if affinity_slack is None:
            affinity_slack = _env_num(
                "PADDLE_TPU_ROUTER_AFFINITY_SLACK", 0.25, float)
        if stream_resume_max is None:
            stream_resume_max = _env_num("PADDLE_TPU_STREAM_RESUME_MAX",
                                         2, int)
        self.heartbeat_miss_k = max(1, int(heartbeat_miss_k))
        self.failover_retries = max(0, int(failover_retries))
        # mid-stream failover: how many resume legs one
        # /generate stream may consume, and which QoS classes are worth
        # the resume re-prefill at all (unset = every class)
        self.stream_resume_max = max(0, int(stream_resume_max))
        self.stream_resume_classes = (
            _qos.resume_classes_from_env()
            if stream_resume_classes is None
            else frozenset(_qos.normalize_class(c)
                           for c in stream_resume_classes) - {None})
        self.affinity_slack = max(0.0, float(affinity_slack))
        self._affinity = OrderedDict()  # fingerprint -> rid (LRU)
        self.probe_interval = float(probe_interval)
        self.request_timeout = (None if request_timeout is None
                                else float(request_timeout))
        self.transport = transport or HTTPTransport()
        self.heartbeats = heartbeats  # callable -> iterable of live ids
        self.clock = clock
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_reset = float(breaker_reset)
        self._lock = threading.Lock()
        self._replicas: dict = {}     # rid -> _Replica (under _lock)
        # ONE fleet-level edge controller per endpoint class: shedding
        # happens once, here, with an honest Retry-After — capacities
        # re-track the live routable fleet on every probe pass
        self.admission = AdmissionController(
            max_inflight=max_inflight, queue_depth=queue_depth,
            name="router")
        self.gen_admission = AdmissionController(
            max_inflight=max_inflight, queue_depth=queue_depth,
            name="router.generate")
        # fleet-level SLO ledger: what the CLIENT-FACING
        # edge delivered — sheds and failed-over-into-errors consume
        # budget here even when every replica's own ledger is clean.
        # Its windowed burn rate is the autoscaler's primary signal.
        self.slo = SLOTracker(
            window_s=_env_num("PADDLE_TPU_SLO_WINDOW", 300.0, float),
            clock=clock)
        paid_avail = _env_num(
            "PADDLE_TPU_SLO_PAID_AVAILABILITY",
            _env_num("PADDLE_TPU_SLO_AVAILABILITY", 0.999, float),
            float)
        for ep, target in (("predict", 1000.0), ("generate", 30000.0)):
            latency_ms = _env_num(
                "PADDLE_TPU_SLO_LATENCY_MS" if ep == "predict"
                else "PADDLE_TPU_SLO_GENERATE_LATENCY_MS",
                target, float)
            self.slo.objective(
                ep, latency_target_ms=latency_ms,
                availability=_env_num("PADDLE_TPU_SLO_AVAILABILITY",
                                      0.999, float))
            # the paid tier's own promise: its burn rate is
            # what the autoscaler scales for — free/batch inherit the
            # endpoint objective (degrading them is the DESIGN under
            # surge, not a page)
            self.slo.objective(ep, latency_target_ms=latency_ms,
                               availability=paid_avail, cls="paid")
        # per-tenant metering at the EDGE: the router's own
        # book bills every request it answers — including sheds and
        # failed failovers a replica never saw, which is exactly what
        # replica-side books cannot capture.  Request counts here and
        # on replicas are per-HOP tallies (like router.requests vs
        # serving.requests); token/page fields bill engine-side only,
        # so the fleet merge of REPLICA books still conserves.
        self.tenant_ledger = _tledger.TenantLedger() \
            if _tledger.enabled() and _metrics.enabled() else None
        # time-dimension telemetry: sampled edge/capacity
        # series behind GET /debug/timeseries (rates + derivatives)
        self.timeseries = _ts.TimeSeriesSampler(names=ROUTER_SERIES,
                                                name="router")
        _ts.set_default_sampler(self.timeseries)
        # replica lifecycle plane: ReplicaFleet wires its
        # FleetLifecycle here so the probe loop can stamp
        # first_probe_up / first_routable_request and durably attach
        # each replica's own phase record.  None for a bare Router.
        self.lifecycle = None
        for rid, address in dict(replicas or {}).items():
            self.add_replica(rid, address)
        self._probe_stop = threading.Event()
        self._probe_thread = None
        self._serving = False
        self._shutdown_lock = threading.Lock()
        self._shutdown_done = False
        router = self

        class Handler(BaseHTTPRequestHandler):
            _rt_ctx = None

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code, obj, headers=()):
                body = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if self._rt_ctx is not None:
                    self.send_header("X-Request-Id",
                                     self._rt_ctx.request_id)
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    return self._json(200, {
                        "status": "ok", "role": "router",
                        "replicas": router.replica_summary()})
                if self.path == "/ready":
                    ready, reason = router.readiness()
                    body = {"status": "ready" if ready else "not_ready",
                            "reason": reason,
                            "routable": router.routable_count()}
                    body.update(router.admission.stats())
                    return self._json(200 if ready else 503, body)
                if self.path == "/replicas":
                    return self._json(200, {
                        "replicas": router.replica_views()})
                if self.path == "/metrics":
                    try:
                        text = _metrics.to_prometheus()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    data = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4; "
                                     "charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if self.path == "/debug/telemetry":
                    try:
                        snap = router.telemetry_snapshot()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    return self._json(200, snap)
                if self.path == "/debug/timeseries":
                    try:
                        body = router.timeseries.describe()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    return self._json(200, body)
                if self.path == "/debug/tenants":
                    # the fleet tenant view: the router's
                    # edge book + every routable replica's table +
                    # their Space-Saving merge
                    try:
                        body = router.tenant_debug()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    return self._json(200, body)
                if self.path == "/debug/lifecycle":
                    # the fleet lifecycle view: per-spawn
                    # joined supervisor+replica phase records, the
                    # spawn-time rollup, and live replica records
                    try:
                        body = router.lifecycle_debug()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    return self._json(200, body)
                return self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path not in ("/predict", "/generate"):
                    return self._json(404, {"error": "unknown path"})
                ctx = _rtrace.continue_from_headers(self.headers)
                if ctx.tenant_id is None:
                    # the router resolves the SAME billing fallback as
                    # the serving edge (fp:<fingerprint>, else anon) so
                    # a shed here and a decode on the replica land in
                    # one ledger row; _route_generate refines anon to a
                    # derived fingerprint before forwarding
                    fp = self.headers.get("X-Prefix-Fingerprint")
                    tid = _tledger.sanitize_tenant(f"fp:{fp}") \
                        if fp else None
                    ctx.tenant_id = tid or _tledger.ANON_TENANT
                # QoS class resolved ONCE at the edge: an
                # explicit valid X-Priority-Class wins, else the
                # tenant->class map, else the default tier.  The
                # resolved class rides the forwarded hop's headers so
                # router and replica agree on the tier.
                ctx.priority_class = _qos.resolve_class(
                    tenant_id=ctx.tenant_id,
                    explicit=ctx.priority_class)
                self._rt_ctx = ctx
                with _rtrace.activate(ctx):
                    if self.path == "/predict":
                        self._route_predict(ctx)
                    else:
                        self._route_generate(ctx)

            # --- /predict: buffered forward with transparent failover --
            def _route_predict(self, ctx):
                t_req = time.perf_counter()
                sp = _trace.begin("router.request", cat="router",
                                  endpoint="predict", **ctx.trace_args())
                status = "error"
                ticket = None
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    deadline = router._deadline(ctx)
                    try:
                        ticket = router.admission.admit(
                            deadline=deadline,
                            priority_class=ctx.priority_class)
                    except ShedError as e:
                        status = "shed"
                        return self._json(
                            e.http_status,
                            {"error": str(e), "reason": e.reason},
                            headers=[("Retry-After",
                                      _retry_after_header(e.retry_after))])
                    try:
                        code, hdrs, data, rid = router.forward_predict(
                            body, ctx,
                            content_type=self.headers.get(
                                "Content-Type",
                                "application/octet-stream"))
                    except ShedError as e:
                        status = "shed"
                        return self._json(
                            e.http_status,
                            {"error": str(e), "reason": e.reason},
                            headers=[("Retry-After",
                                      _retry_after_header(e.retry_after))])
                    except Exception as e:
                        # a router bug must still answer the client
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    if sp is not None:
                        sp.args["replica"] = rid
                    status = ("ok" if code == 200 else
                              "client_error" if code == 400 else
                              "shed" if code in (429, 503) else "error")
                    self.send_response(code)
                    self.send_header(
                        "Content-Type",
                        hdrs.get("Content-Type",
                                 "application/octet-stream"))
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("X-Request-Id", ctx.request_id)
                    if "Retry-After" in hdrs:
                        self.send_header("Retry-After",
                                         hdrs["Retry-After"])
                    self.end_headers()
                    self.wfile.write(data)
                finally:
                    if ticket is not None:
                        ticket.release(ok=status == "ok")
                    router._finish_request("predict", status, sp, t_req,
                                           tenant_id=ctx.tenant_id,
                                           cls=ctx.priority_class)

            # --- /generate: streamed forward -------------------------
            def _route_generate(self, ctx):
                t_req = time.perf_counter()
                sp = _trace.begin("router.request", cat="router",
                                  endpoint="generate", **ctx.trace_args())
                status = "error"
                ticket = None
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    try:
                        parsed = json.loads(body or b"{}")
                        prompt = [int(x) for x in
                                  parsed.get("input_ids", [])]
                    except Exception:
                        parsed = {}
                        prompt = []  # replica will 400 it; no prefix
                    # prefix-affinity fingerprint: the client's header
                    # wins; otherwise derive one from the parsed prompt
                    # so plain clients still get affinity.  Either way
                    # it is ONLY a routing hint — the engine matches
                    # real tokens, so a poisoned header cannot change
                    # the stream, only the replica it lands on.
                    fingerprint = self.headers.get(
                        "X-Prefix-Fingerprint")
                    if fingerprint is None and prompt:
                        from .serving import InferenceClient

                        fingerprint = InferenceClient.prefix_fingerprint(
                            prompt)
                        if ctx.tenant_id == _tledger.ANON_TENANT \
                                and fingerprint:
                            # refine the billing fallback with the
                            # derived fingerprint BEFORE forwarding, so
                            # router and replica book the same cohort
                            # key (the forwarded hop carries it)
                            ctx.tenant_id = _tledger.sanitize_tenant(
                                f"fp:{fingerprint}") \
                                or _tledger.ANON_TENANT
                    deadline = router._deadline(ctx)
                    try:
                        ticket = router.gen_admission.admit(
                            deadline=deadline,
                            priority_class=ctx.priority_class)
                    except ShedError as e:
                        status = "shed"
                        return self._json(
                            e.http_status,
                            {"error": str(e), "reason": e.reason},
                            headers=[("Retry-After",
                                      _retry_after_header(e.retry_after))])
                    try:
                        status = router.forward_generate(
                            body, prompt, ctx, self,
                            fingerprint=fingerprint,
                            max_new_tokens=parsed.get(
                                "max_new_tokens"),
                            eos_token_id=parsed.get("eos_token_id"))
                    except Exception as e:
                        # best effort: before any stream bytes this is
                        # a clean 500; afterwards the socket just
                        # closes (the client's parser notices the
                        # missing final record)
                        status = "error"
                        try:
                            self._json(500, {"error":
                                             f"{type(e).__name__}: {e}"})
                        except Exception:  # pt-lint: ok[PT005]
                            pass  # headers already sent mid-stream
                finally:
                    if ticket is not None:
                        ticket.release(ok=status == "ok")
                    router._finish_request("generate", status, sp, t_req,
                                           tenant_id=ctx.tenant_id,
                                           cls=ctx.priority_class)

        self._httpd = _RouterHTTPServer((host, port), Handler)
        self._thread = None

    # ------------------------------------------------------------------
    # membership (the fleet drives these; also usable standalone)
    # ------------------------------------------------------------------
    def add_replica(self, rid, address):
        """Register a replica.  It starts `down` and enters rotation
        when the probe loop sees it ready (a just-launched replica must
        pass readiness before traffic)."""
        breaker = CircuitBreaker(
            failure_threshold=self._breaker_threshold,
            reset_timeout=self._breaker_reset, clock=self.clock,
            name=f"router.{rid}")
        with self._lock:
            self._replicas[str(rid)] = _Replica(rid, address, breaker)
        self._note("router.replica_added", replica=str(rid),
                   address=str(address))
        self._publish_state_gauges()
        return self

    def update_replica(self, rid, address):
        """Point `rid` at a relaunched process (new address).  State
        resets to `down`; the probe loop re-admits it after readiness
        passes, counting a `router.readmissions`."""
        with self._lock:
            rep = self._replicas.get(str(rid))
        if rep is None:
            return self.add_replica(rid, address)
        with self._lock:
            rep.address = str(address)
            rep.state = "down"
            rep.signals = {}
            rep.missed_heartbeats = 0
            rep.probe_failures = 0
            rep.generation += 1
            rep.draining_requested = False
            rep.ever_beat = False  # the new process must beat before
            # heartbeat absence can count against it again
            rep.ever_forwarded = False  # the relaunch opened a fresh
            # spawn record: its first forward is a first again
            rep.breaker.record_success()  # fresh process, fresh slate
        self._note("router.replica_relaunched", replica=str(rid),
                   address=str(address))
        self._publish_state_gauges()
        return self

    def remove_replica(self, rid):
        with self._lock:
            self._replicas.pop(str(rid), None)
        self._publish_state_gauges()

    def mark_draining(self, rid):
        """Take `rid` out of rotation NOW — the fleet calls this BEFORE
        delivering SIGTERM, so by the time the replica's own
        `PreemptionGuard` flips it to draining no new traffic is headed
        there (no thundering 503s)."""
        with self._lock:
            rep = self._replicas.get(str(rid))
            if rep is None:
                return False
            rep.draining_requested = True
            if rep.state == "up":
                rep.state = "draining"
        self._note("router.replica_draining", replica=str(rid))
        self._publish_state_gauges()
        return True

    def note_replica_down(self, rid):
        """Immediate death notice (the fleet saw the process exit):
        faster than waiting out K missed heartbeats."""
        ejected = False
        with self._lock:
            rep = self._replicas.get(str(rid))
            if rep is None:
                return False
            if rep.state not in ("down", "ejected"):
                ejected = rep.state != "draining"
                rep.state = "down"
        if ejected:
            _metrics.inc("router.ejections")
            self._note("router.replica_down", replica=str(rid))
        self._publish_state_gauges()
        return True

    def inflight_to(self, rid):
        """Router-side in-flight request count toward one replica (the
        fleet waits for this to hit 0 before SIGTERMing a drained
        replica)."""
        with self._lock:
            rep = self._replicas.get(str(rid))
            return sum(rep.inflight.values()) if rep is not None else 0

    def replica_views(self):
        with self._lock:
            return [r.view() for r in self._replicas.values()]

    def replica_summary(self):
        with self._lock:
            return {r.id: r.state for r in self._replicas.values()}

    def routable_count(self):
        with self._lock:
            return len(self._routable_locked())

    def readiness(self):
        if self.admission.draining:
            return False, "draining"
        if self.routable_count() == 0:
            return False, "no_replicas"
        return True, "ok"

    # ------------------------------------------------------------------
    # probe loop: readiness signals, heartbeats, state transitions
    # ------------------------------------------------------------------
    def probe_once(self):
        """One probe pass (the loop body; tests call it directly with a
        fake transport/heartbeat source).  Readiness probes every
        replica, folds in the heartbeat view, applies state
        transitions, republishes gauges, and re-tracks the edge
        admission capacities."""
        alive = None
        if self.heartbeats is not None:
            try:
                alive = {str(r) for r in self.heartbeats()}
            except Exception as e:  # pt-lint: ok[PT005]
                alive = None  # a broken heartbeat source must not
                # eject the whole fleet — fall back to probe-only
                # liveness for this pass (and leave a trace of it)
                self._note("router.heartbeat_source_error",
                           error=f"{type(e).__name__}: {e}")
        with self._lock:
            targets = [(r.id, r.address, r.generation)
                       for r in self._replicas.values()]
        for rid, address, gen in targets:
            ok, payload = self._probe_replica(address)
            self._apply_probe(rid, gen, ok, payload, alive)
        self._publish_state_gauges()
        self._retrack_capacity()

    def _probe_replica(self, address):
        try:
            code, _hdrs, body = self.transport.request(
                address, "GET", "/ready", timeout=max(
                    1.0, self.probe_interval * 4))
            try:
                payload = json.loads(body or b"{}")
            except ValueError:
                payload = {}
            payload["_ready"] = code == 200
            return True, payload
        except Exception:
            return False, None

    def _apply_probe(self, rid, gen, ok, payload, alive):
        readmitted = ejected = None
        came_up = False
        address = None
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.generation != gen:
                return  # relaunched mid-probe: stale result
            if ok:
                rep.probe_failures = 0
                rep.signals = payload
            else:
                rep.probe_failures += 1
            if alive is not None:
                if rid in alive:
                    rep.ever_beat = True
                    rep.missed_heartbeats = 0
                elif rep.ever_beat:
                    rep.missed_heartbeats += 1
                # never beat: this replica's heartbeat plane never came
                # up (fleet degrades it to probe-only liveness) — its
                # absence from `alive` is not evidence of death, and
                # counting it would brick a perfectly ready replica
            misses = max(rep.missed_heartbeats, rep.probe_failures)
            if rep.state in ("up", "draining"):
                if misses >= self.heartbeat_miss_k:
                    # deliberate drains exit quietly; anything else
                    # is an ejection (it held traffic until now)
                    ejected = not rep.draining_requested
                    rep.state = "ejected" if ejected else "down"
                elif ok and not payload.get("_ready") and \
                        str(payload.get("reason")) == "draining":
                    rep.state = "draining"
                elif rep.state == "draining" and ok \
                        and payload.get("_ready") \
                        and not rep.draining_requested:
                    # the replica's drain was observed, not requested
                    # by the fleet, and its readiness recovered: back
                    # into rotation (a fleet-requested drain sticks
                    # until SIGTERM/exit — flipping back would race
                    # the drain ordering)
                    rep.state = "up"
            elif rep.state in ("down", "ejected")  \
                    and ok and payload.get("_ready") and misses == 0:
                # first-ever admission is just startup; anything after
                # the replica has held traffic (or been relaunched) is
                # a re-admission worth counting
                if rep.ever_up:
                    readmitted = rep.state
                rep.state = "up"
                rep.ever_up = True
                rep.draining_requested = False
                rep.breaker.record_success()
                came_up = True
                address = rep.address
        if came_up and self.lifecycle is not None:
            # lifecycle: first probe-up closes the
            # spawn-to-routable interval (first-wins per spawn record —
            # a relaunch opened a fresh record, so its re-admission
            # stamps again), then the replica's own phase record is
            # fetched and attached DURABLY: a scale-down later must not
            # erase the spawn story the surge gate audits
            try:
                if self.lifecycle.stamp(rid, "first_probe_up"):
                    code, _hdrs, body = self.transport.request(
                        address, "GET", "/debug/lifecycle",
                        timeout=max(1.0, self.probe_interval * 4))
                    if code == 200:
                        self.lifecycle.attach_replica_record(
                            rid, json.loads(body or b"{}"))
            except Exception as e:  # pt-lint: ok[PT005]
                # observability of observability: a lost record is a
                # note, never a probe failure
                self._note("router.lifecycle_attach_failed",
                           replica=rid, error=type(e).__name__)
        if ejected:
            _metrics.inc("router.ejections")
            self._note("router.replica_ejected", replica=rid)
        elif ejected is False:
            self._note("router.replica_drained_out", replica=rid)
        if readmitted is not None:
            _metrics.inc("router.readmissions")
            self._note("router.replica_readmitted", replica=rid,
                       was=readmitted)

    def _probe_loop(self):
        while not self._probe_stop.wait(self.probe_interval):
            try:
                self.probe_once()
            except Exception as e:  # pt-lint: ok[PT005]
                # the probe loop is the router's heart — one bad pass
                # (a replica racing teardown, a malformed payload) must
                # not stop all future probing.  Leave evidence.
                self._note("router.probe_error",
                           error=f"{type(e).__name__}: {e}")

    def _retrack_capacity(self):
        """Edge admission capacity = what the routable fleet can
        actually run concurrently right now.  Published as
        `router.capacity{endpoint}` gauges so the fleet's
        routable headroom is scrapeable next to the autoscaler's
        replica gauges — zero IS a meaningful reading (nothing
        routable), so the gauges publish unconditionally even though
        the controllers only re-track positive capacity."""
        predict_cap = 0
        gen_cap = 0
        with self._lock:
            for rid in self._routable_locked():
                sig = self._replicas[rid].signals
                predict_cap += int(sig.get("admission_limit")
                                   or sig.get("limit") or 1)
                eng = sig.get("engine") or {}
                gen_cap += int(eng.get("max_slots") or 0)
        _metrics.set_gauge("router.capacity", predict_cap,
                           endpoint="predict")
        _metrics.set_gauge("router.capacity", gen_cap,
                           endpoint="generate")
        if predict_cap > 0:
            self.admission.set_capacity(predict_cap)
        if gen_cap > 0:
            self.gen_admission.set_capacity(gen_cap)

    def _routable_locked(self):  # pt-lint: ok[PT102] (callers hold _lock)
        return [rid for rid, rep in self._replicas.items()
                if rep.state == "up"
                and rep.signals.get("_ready", False)
                and rep.breaker.state != "open"]

    def routable_ids(self):
        """Replica ids currently in rotation — the autoscaler's
        scale-down candidate set (a drain must target a replica that
        is actually carrying traffic state, never one already
        draining/ejected/down)."""
        with self._lock:
            return list(self._routable_locked())

    def affinity_counts(self):
        """Live prefix-affinity population per replica id: how many
        fingerprints in the bounded LRU map currently point at each
        replica.  The autoscaler uses this to pick the LEAST
        affinity-hot routable replica for scale-down — draining the
        replica most prefixes are warm on would trade every one of
        those tenants' TTFT for nothing."""
        with self._lock:
            counts: dict = {}
            for rid in self._affinity.values():
                counts[rid] = counts.get(rid, 0) + 1
            return counts

    # ------------------------------------------------------------------
    # pick + forward
    # ------------------------------------------------------------------
    def _pick(self, endpoint, exclude=(), fingerprint=None):
        """Least-loaded routable replica for `endpoint`, or None.
        Load = the replica's own admission view (stale by at most one
        probe) plus the router's live in-flight count toward it.

        With a `fingerprint`: prefer the replica this
        prefix last landed on — but ONLY while its load stays within
        `affinity_slack` of the least-loaded candidate (affinity must
        never become a hot spot), and only when it is currently
        routable (never a drained/ejected/breaker-open replica: those
        never enter the candidate set).  Every pick refreshes the
        bounded LRU fingerprint map, so the affinity self-corrects as
        the fleet changes."""
        loads = {}
        outcome = None
        with self._lock:
            for rid in self._routable_locked():
                if rid in exclude:
                    continue
                rep = self._replicas[rid]
                sig = rep.signals
                if endpoint == "generate":
                    eng = sig.get("engine") or {}
                    slots = max(1, int(eng.get("max_slots") or 1))
                    load = (float(eng.get("active_sequences") or 0)
                            + float(eng.get("waiting_sequences") or 0)
                            + rep.inflight["generate"]) / slots
                else:
                    limit = max(1, int(sig.get("admission_limit")
                                       or sig.get("limit") or 1))
                    load = (float(sig.get("inflight") or 0)
                            + float(sig.get("queued") or 0)
                            + rep.inflight["predict"]) / limit
                loads[rid] = load
            if not loads:
                return None
            pick = min(loads, key=lambda r: (loads[r], r))
            if fingerprint is not None:
                affine = self._affinity.get(fingerprint)
                if affine in loads and loads[affine] <= \
                        loads[pick] + self.affinity_slack:
                    pick = affine
                    outcome = "affine"
                else:
                    outcome = "least_loaded"
                self._affinity[fingerprint] = pick
                self._affinity.move_to_end(fingerprint)
                while len(self._affinity) > self.AFFINITY_CAP:
                    self._affinity.popitem(last=False)
        if outcome is not None:
            _metrics.inc("router.affinity", outcome=outcome)
        return pick

    def _begin_forward(self, rid, endpoint):
        first = False
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return None
            rep.inflight[endpoint] += 1
            if not rep.ever_forwarded:
                rep.ever_forwarded = True
                first = True
            address = rep.address
        if first and self.lifecycle is not None:
            # lifecycle: the spawn record's first routed
            # request (first-wins — the flag keeps the common path to
            # one boolean test, the ledger dedups relaunch races)
            try:
                self.lifecycle.stamp(rid, "first_routable_request")
            except Exception:  # pt-lint: ok[PT005]
                pass  # never fail a forward for a lost stamp
        return address

    def _end_forward(self, rid, endpoint):
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is not None:
                rep.inflight[endpoint] = max(
                    0, rep.inflight[endpoint] - 1)

    def _forward_failed(self, rid, err):
        """Book a transport-level forward failure: feeds the breaker
        (pick skips open breakers) and leaves a flight event.  The
        probe loop does the actual ejection — one failed forward is a
        failover, not a funeral."""
        with self._lock:
            rep = self._replicas.get(rid)
            breaker = rep.breaker if rep is not None else None
        if breaker is not None:
            breaker.record_failure()
        self._note("router.forward_failed", replica=rid,
                   error=f"{type(err).__name__}: {err}")

    def _no_replica_shed(self, last_shed):
        """End of the failover loop with nothing served: prefer the
        honest replica-provided shed (its Retry-After reflects real
        queue depth); otherwise the fleet is gone — 503 no_replicas."""
        if last_shed is not None:
            code, hdrs, data = last_shed
            return code, hdrs, data
        _metrics.inc("resilience.shed_requests", reason="no_replicas")
        self._note("router.no_replicas")
        raise ShedError("no_replicas",
                        retry_after=self.probe_interval
                        * self.heartbeat_miss_k + 1.0,
                        detail="no routable replica")

    def forward_predict(self, body, ctx, content_type=None):
        """Forward one buffered /predict: returns (status, headers,
        body, replica_id).  Transparent failover on transport failure
        or replica shed, always under the SAME X-Request-Id (`ctx` is
        this hop's context; every attempt reuses its headers).  Raises
        ShedError("no_replicas") when nothing routable remains."""
        from ..resilience import faults as _faults

        hop = ctx.child()
        headers = {"Content-Type": content_type
                   or "application/octet-stream"}
        headers.update(hop.to_headers())
        tried: set = set()
        last_shed = None
        attempts = self.failover_retries + 1
        for attempt in range(attempts):
            rid = self._pick("predict", exclude=tried)
            if rid is None:
                break
            tried.add(rid)
            address = self._begin_forward(rid, "predict")
            if address is None:
                continue
            sp = _trace.begin("router.forward", cat="router",
                              replica=rid, endpoint="predict",
                              attempt=attempt, **ctx.trace_args())
            try:
                _faults.fire("router.forward", replica=rid,
                             endpoint="predict")
                self._breaker_allow(rid)
                code, hdrs, data = self.transport.request(
                    address, "POST", "/predict", body=body,
                    headers=headers, timeout=self.request_timeout)
            except CircuitOpenError:
                continue
            except Exception as e:
                self._forward_failed(rid, e)
                if attempt < attempts - 1:
                    _metrics.inc("router.failovers")
                continue
            finally:
                self._end_forward(rid, "predict")
                _trace.end(sp)
            self._breaker_success(rid)
            if code in (429, 503):
                # the replica is alive but shedding — its estimate was
                # fresher than our probe; try a less-loaded one, and
                # keep ITS Retry-After as the honest fallback answer
                self._maybe_mark_draining(rid, data)
                last_shed = (code, hdrs, data)
                continue
            return code, hdrs, data, rid
        code, hdrs, data = self._no_replica_shed(last_shed)
        return code, hdrs, data, None

    def _maybe_mark_draining(self, rid, data):
        try:
            if json.loads(data or b"{}").get("reason") == "draining":
                self.mark_draining(rid)
        except ValueError:  # pt-lint: ok[PT005]
            pass  # non-JSON shed body: the probe loop will notice

    def _breaker_allow(self, rid):
        with self._lock:
            rep = self._replicas.get(rid)
            breaker = rep.breaker if rep is not None else None
        if breaker is not None:
            breaker.allow()

    def _breaker_success(self, rid):
        with self._lock:
            rep = self._replicas.get(rid)
            breaker = rep.breaker if rep is not None else None
        if breaker is not None:
            breaker.record_success()

    def forward_generate(self, body, prompt_ids, ctx, handler,
                         fingerprint=None, max_new_tokens=None,
                         eos_token_id=None):
        """Proxy one /generate stream to the client behind `handler`.

        Failover contract: attempts rotate
        replicas under ONE request id while ZERO token lines have been
        written to the client.  Once tokens ARE delivered, a replica
        failure triggers a deterministic mid-stream RESUME: the router
        resubmits `prompt + delivered[:-1]` as the next leg's prompt
        (valid by the greedy determinism contract — delivered tokens
        are the argmax continuations) with the budget reduced
        accordingly, still under the same request id; the resume
        replica tail-prefills (usually a prefix-cache hit) and must
        reproduce `delivered[-1]` as its FIRST token — the divergence
        check.  The verify token is swallowed (the client already has
        it), so the stream continues from token N with zero replay and
        no client-visible seam beyond latency; the final record gains
        a `"resumed": n` field.  Resume is bounded
        (`stream_resume_max` legs), deadline-aware (never past the
        edge deadline) and class-gated (`stream_resume_classes`); any
        refusal, divergence, or replica exhaustion falls back LOUDLY
        to the single clean `interrupted` record carrying `output_ids`
        = prompt + delivered tokens — the stream NEVER replays or
        invents a token.  Returns the request's status label.
        `fingerprint` biases every pick toward the prefix-affine
        replica (see `_pick`); the header rides through untouched."""
        from ..resilience import faults as _faults

        hop = ctx.child()
        headers = {"Content-Type": "application/json"}
        headers.update(hop.to_headers())
        if fingerprint is not None:
            headers["X-Prefix-Fingerprint"] = str(fingerprint)
        prompt_ids = [int(x) for x in prompt_ids]
        max_new = max(1, int(max_new_tokens
                             if max_new_tokens is not None else 32))
        deadline_abs = self._deadline(ctx)
        tried: set = set()
        last_shed = None
        started = False          # client response headers sent?
        delivered: list = []     # token values already written out
        resumes = 0              # resume legs begun
        verify_expect = None     # resume leg must reproduce this first
        pending_ok = False       # resume leg awaiting its first token
        last_token_at = None     # resume-gap clock anchor
        cur_body = body          # current leg's request body
        attempts = self.failover_retries + 1
        fresh_tries = 0
        while True:
            if not delivered and not started:
                if fresh_tries >= attempts:
                    break
                fresh_tries += 1
            rid = self._pick("generate", exclude=tried,
                             fingerprint=fingerprint)
            if rid is None:
                break
            tried.add(rid)
            address = self._begin_forward(rid, "generate")
            if address is None:
                continue
            resuming = bool(delivered or started)
            sp = _trace.begin("router.forward", cat="router",
                              replica=rid, endpoint="generate",
                              attempt=len(tried) - 1, resume=resumes,
                              **ctx.trace_args())
            stream = None
            try:
                _faults.fire("router.forward", replica=rid,
                             endpoint="generate")
                self._breaker_allow(rid)
                stream = self.transport.stream(
                    address, "/generate", cur_body, headers=headers,
                    timeout=self.request_timeout)
            except CircuitOpenError:
                self._end_forward(rid, "generate")
                _trace.end(sp)
                continue
            except Exception as e:
                self._forward_failed(rid, e)
                self._end_forward(rid, "generate")
                _trace.end(sp)
                if not resuming and fresh_tries < attempts:
                    _metrics.inc("router.failovers")
                continue
            try:
                self._breaker_success(rid)  # status line arrived
                if stream.status in (429, 503):
                    data = stream.read_body()
                    self._maybe_mark_draining(rid, data)
                    if not resuming:
                        last_shed = (stream.status,
                                     dict(stream.headers), data)
                    continue  # a shed resume leg: try the next replica
                if stream.status != 200:
                    if resuming:
                        # a deterministic 4xx/5xx on the ROUTER-built
                        # resume body is a fleet problem, not a client
                        # one: fall back to the interrupted record
                        raise ReplicaUnreachable(
                            f"{rid}: resume leg answered "
                            f"{stream.status}")
                    # deterministic replica answer (400 etc.): pass
                    # through — it would fail identically anywhere
                    data = stream.read_body()
                    handler._json(stream.status, _safe_json(data))
                    return ("client_error" if stream.status == 400
                            else "error")
                done_seen = False
                lines = stream.lines()
                while True:
                    # replica-read and client-write failures MUST be
                    # told apart (both raise OSError subclasses): a
                    # dead replica fails over / resumes / interrupts
                    # cleanly, a dead client cancels upstream — so the
                    # two I/O directions get separate try blocks
                    try:
                        line = next(lines)
                        _faults.fire("router.stream_read", replica=rid,
                                     delivered=len(delivered))
                    except StopIteration:
                        break
                    except (_faults.InjectedFault, OSError,
                            http.client.HTTPException) as e:
                        raise ReplicaUnreachable(
                            f"{rid}: {type(e).__name__}: {e}") from e
                    if not line.strip():
                        continue
                    evt = _safe_json(line)
                    has_token = "token" in evt
                    if verify_expect is not None and has_token:
                        # divergence check: the resume
                        # leg's first token re-derives delivered[-1];
                        # it is swallowed either way — the client
                        # already has it, and a mismatch must fall
                        # back to the clean interrupted record, never
                        # stream a wrong token
                        got = int(evt["token"])
                        injected = False
                        try:
                            _faults.fire("router.resume_verify",
                                         replica=rid, got=got)
                        except _faults.InjectedFault:
                            injected = True
                        if injected or got != verify_expect:
                            _metrics.inc("router.stream_resumes",
                                         outcome="diverged")
                            self._note("router.resume_diverged",
                                       replica=rid,
                                       expected=int(verify_expect),
                                       got=got, injected=injected,
                                       delivered=len(delivered))
                            return self._interrupt_stream(
                                handler, ctx, rid, prompt_ids,
                                delivered,
                                "resume diverged from delivered "
                                "prefix")
                        verify_expect = None
                        self._resume_established(
                            rid, last_token_at, len(delivered))
                        last_token_at = self.clock()
                        continue   # swallowed: the client has it
                    if pending_ok and has_token:
                        # resume leg with nothing to verify (the break
                        # landed between headers and the first token):
                        # established at its first real token
                        pending_ok = False
                        self._resume_established(
                            rid, last_token_at, len(delivered))
                    if evt.get("done") and resumes:
                        # the client learns its stream absorbed
                        # failovers (loadgen counts resumed_streams)
                        evt["resumed"] = resumes
                        line = json.dumps(evt).encode() + b"\n"
                    try:
                        if not started:
                            started = True
                            handler.send_response(200)
                            handler.send_header(
                                "Content-Type", "application/x-ndjson")
                            handler.send_header("X-Request-Id",
                                                ctx.request_id)
                            handler.send_header("Connection", "close")
                            handler.end_headers()
                        handler.wfile.write(line)
                        handler.wfile.flush()
                    except (BrokenPipeError, ConnectionError,
                            OSError) as e:
                        # the CLIENT went away: closing the replica
                        # stream (finally below) cancels the sequence
                        self._note("router.client_disconnect",
                                   replica=rid,
                                   error=f"{type(e).__name__}: {e}")
                        return "client_error"
                    if has_token:
                        delivered.append(int(evt["token"]))
                        last_token_at = self.clock()
                    if evt.get("done"):
                        done_seen = True
                        break
                if done_seen:
                    return "ok"
                # replica stream ended without a final record: the
                # process died mid-generation (kill -9 chaos path)
                raise ReplicaUnreachable(
                    f"{rid}: stream ended without final record")
            except (ReplicaUnreachable, OSError,
                    http.client.HTTPException) as e:
                self._forward_failed(rid, e)
                if not delivered and not started:
                    if fresh_tries < attempts:
                        _metrics.inc("router.failovers")
                    continue  # zero tokens delivered: safe to fail over
                # tokens already delivered: deterministic mid-stream
                # resume, bounded / deadline- / class-gated
                refusal = self._resume_refusal(ctx, resumes,
                                               deadline_abs)
                if refusal is not None:
                    _metrics.inc("router.stream_resumes",
                                 outcome="exhausted")
                    self._note("router.resume_refused", replica=rid,
                               reason=refusal,
                               delivered=len(delivered))
                    return self._interrupt_stream(
                        handler, ctx, rid, prompt_ids, delivered,
                        f"replica failed mid-stream: "
                        f"{type(e).__name__}")
                resumes += 1
                cur_body, verify_expect = self._resume_body(
                    prompt_ids, delivered, max_new, eos_token_id,
                    resumes)
                pending_ok = verify_expect is None
                if last_token_at is None:
                    last_token_at = self.clock()
                self._note("router.stream_resume", replica=rid,
                           leg=resumes, delivered=len(delivered),
                           error=f"{type(e).__name__}: {e}")
                continue
            finally:
                self._end_forward(rid, "generate")
                _trace.end(sp)
                if stream is not None:
                    stream.close()
        if started or delivered:
            # mid-stream loss with no replica left to resume on
            _metrics.inc("router.stream_resumes", outcome="exhausted")
            self._note("router.resume_refused", reason="no_replica",
                       delivered=len(delivered))
            return self._interrupt_stream(
                handler, ctx, None, prompt_ids, delivered,
                "replica failed mid-stream: no replica available "
                "for resume")
        # nothing started: we can still answer with a clean status
        try:
            code, hdrs, data = self._no_replica_shed(last_shed)
        except ShedError as e:
            handler._json(e.http_status,
                          {"error": str(e), "reason": e.reason},
                          headers=[("Retry-After",
                                    _retry_after_header(e.retry_after))])
            return "shed"
        handler._json(code, _safe_json(data),
                      headers=[("Retry-After", hdrs["Retry-After"])]
                      if "Retry-After" in hdrs else ())
        return "shed"

    # --- mid-stream resume internals -----------------------
    def _resume_refusal(self, ctx, resumes, deadline_abs):
        """Why a mid-stream resume must NOT be attempted, or None when
        it may: budget spent, class not served, or the edge deadline
        already passed (resuming a stream nobody will wait for only
        burns a tail-prefill)."""
        if resumes >= self.stream_resume_max:
            return "budget"
        cls = ctx.priority_class or _qos.DEFAULT_CLASS
        if cls not in self.stream_resume_classes:
            return "class"
        if deadline_abs is not None and self.clock() >= deadline_abs:
            return "deadline"
        return None

    @staticmethod
    def _resume_body(prompt_ids, delivered, max_new, eos_token_id,
                     leg):
        """The resume leg's request body + the verify token.

        `prompt + delivered[:-1]` is resubmitted as the prompt — by
        the greedy determinism contract its argmax continuation is
        exactly `delivered[-1]`, which the resume replica re-derives
        as its first token (the divergence check; billed nowhere,
        `prebilled_tokens=1`).  The budget grows by that one verify
        token so the stream still ends at the original `max_new` —
        including the edge where every budgeted token was already
        delivered and only the final record was lost (a one-token
        leg that finishes `length`/`eos` immediately)."""
        if delivered:
            ids = list(prompt_ids) + [int(t) for t in delivered[:-1]]
            budget = max_new - len(delivered) + 1
            verify = int(delivered[-1])
        else:
            # broke between the response headers and the first token:
            # a plain full-budget resubmit, nothing to verify
            ids = list(prompt_ids)
            budget = max_new
            verify = None
        body = {"input_ids": ids,
                "max_new_tokens": max(1, int(budget)),
                "resume": int(leg),
                "prebilled_tokens": 0 if verify is None else 1}
        if eos_token_id is not None:
            body["eos_token_id"] = int(eos_token_id)
        return json.dumps(body).encode(), verify

    def _resume_established(self, rid, last_token_at, n_delivered):
        """A resume leg reconnected the stream: count it and attribute
        the client-visible gap (last delivered token -> the resumed
        leg's verify/first token)."""
        _metrics.inc("router.stream_resumes", outcome="ok")
        gap_ms = None
        if last_token_at is not None:
            gap_ms = max(0.0, (self.clock() - last_token_at) * 1e3)
            _metrics.observe("router.resume_gap_ms", gap_ms)
        self._note("router.stream_resumed", replica=rid,
                   delivered=n_delivered,
                   gap_ms=None if gap_ms is None
                   else round(gap_ms, 3))

    def _interrupt_stream(self, handler, ctx, rid, prompt_ids,
                          delivered, why):
        """The LOUD fallback: one clean `interrupted` record carrying
        the resumable prefix — never a replayed or invented token."""
        final = {
            "interrupted": True,
            "error": why,
            "finish_reason": "replica_lost",
            "request_id": ctx.request_id,
            "tokens_delivered": len(delivered),
            "output_ids": list(prompt_ids) + [int(t)
                                              for t in delivered],
        }
        try:
            handler.wfile.write(json.dumps(final).encode() + b"\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):  # pt-lint: ok[PT005]
            pass  # client gone too: nothing left to tell it
        self._note("router.stream_interrupted", replica=rid,
                   delivered=len(delivered))
        return "interrupted"

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _deadline(self, ctx=None):
        """Edge deadline: the router's request timeout, tightened by a
        client-declared X-Deadline-Ms budget — a request
        that cannot finish inside its own budget should shed with
        `deadline`, not camp the queue."""
        deadline = (None if self.request_timeout is None
                    else self.clock() + self.request_timeout)
        if ctx is not None and ctx.deadline_ms is not None:
            client_dl = self.clock() + ctx.deadline_ms / 1e3
            deadline = (client_dl if deadline is None
                        else min(deadline, client_dl))
        return deadline

    def _finish_request(self, endpoint, status, sp, t_req,
                        tenant_id=None, cls=None):
        dt_ms = (time.perf_counter() - t_req) * 1e3
        if sp is not None:
            sp.args["status"] = status
        _trace.end(sp)
        _metrics.observe("router.request_ms", dt_ms,
                         endpoint=endpoint, status=status)
        _metrics.inc("router.requests", endpoint=endpoint,
                     status=status)
        if self.tenant_ledger is not None:
            # edge billing: sheds and failovers the fleet
            # never served still bill the right tenant (`interrupted`
            # books as error — the bounded-status discipline)
            self.tenant_ledger.record_request(tenant_id, status)
        # fleet-level SLO ledger: every edge shed and every
        # request the failover machinery could NOT save burns budget —
        # the burn rate over this ledger is what the autoscaler scales
        # on.  Client-fault 400s are excluded (same rule as serving:
        # the availability promise is about the fleet, and a
        # misbehaving client must not buy itself more replicas).
        if status == "ok":
            self.slo.observe(endpoint, dt_ms, ok=True, cls=cls)
        elif status == "shed":
            self.slo.record_shed(endpoint, "edge", cls=cls)
        elif status in ("error", "interrupted", "timeout"):
            self.slo.observe(endpoint, dt_ms, ok=False, reason=status,
                             cls=cls)

    def _publish_state_gauges(self):
        counts = dict.fromkeys(_REPLICA_STATES, 0)
        with self._lock:
            for rep in self._replicas.values():
                counts[rep.state] = counts.get(rep.state, 0) + 1
        for state, n in counts.items():
            _metrics.set_gauge("router.replicas", n, state=state)

    @staticmethod
    def _note(kind, **data):
        try:
            from ..observability import flight as _flight

            _flight.record(kind, **data)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: routing must
            # route even when telemetry is broken)

    def telemetry_snapshot(self):
        import os as _os

        ready, reason = self.readiness()
        # SLO report first: it publishes the slo.* gauges the metrics
        # snapshot should carry (same ordering as serving's snapshot)
        slo_report = self.slo.report()
        snap = {
            "t": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "pid": _os.getpid(),
            "role": "router",
            "metrics": _metrics.snapshot(),
            "slo": slo_report,
            "admission": self.admission.stats(),
            "gen_admission": self.gen_admission.stats(),
            "readiness": {"ready": ready, "reason": reason},
            "replicas": self.replica_views(),
            "timeseries": self.timeseries.stats(),
        }
        if self.tenant_ledger is not None:
            snap["tenants"] = self.tenant_ledger.snapshot()
        if self.lifecycle is not None:
            # the fleet's spawn records + rollup — joined
            # supervisor/replica views, no live re-fetch (the full
            # fleet view with live replica records is /debug/lifecycle)
            snap["lifecycle"] = self.lifecycle.fleet_view()
        return snap

    def tenant_debug(self):
        """GET /debug/tenants body: the live-fleet tenant view.

        `router` is this edge's own book (every answered request,
        including sheds no replica saw); `replicas` holds each routable
        replica's ledger snapshot fetched over HTTP; `fleet` is their
        Space-Saving merge — REPLICA books only, because router and
        replica both bill requests at their own hop and summing the two
        would double-count (`tools/telemetry_agg.py` applies the same
        rule to exporter dumps).  An unreachable replica is skipped and
        named in `unreachable` — a partial fleet view says so."""
        with self._lock:
            targets = [(rep.id, rep.address)
                       for rep in self._replicas.values()
                       if rep.state in ("up", "draining")]
        per, unreachable = {}, []
        for rid, address in sorted(targets):
            try:
                code, _hdrs, body = self.transport.request(
                    address, "GET", "/debug/tenants",
                    timeout=max(1.0, self.probe_interval * 4))
                snap = json.loads(body or b"{}")
                if code == 200 and isinstance(snap, dict):
                    per[rid] = snap
                else:
                    unreachable.append(rid)
            except Exception:
                unreachable.append(rid)
        out = {"role": "router", "replicas": per,
               "fleet": _tledger.merge_snapshots(list(per.values()))}
        if self.tenant_ledger is not None:
            out["router"] = self.tenant_ledger.snapshot()
        if unreachable:
            out["unreachable"] = unreachable
        return out

    def lifecycle_debug(self):
        """GET /debug/lifecycle body: the fleet lifecycle view.

        `fleet` is the supervisor's joined per-spawn records +
        percentile rollup (durable — scale-downs keep their story);
        `replicas` holds each routable replica's LIVE ledger record
        fetched over HTTP (a replica that has served shows first_token
        here before the durable record learns it).  An unreachable
        replica is skipped and named in `unreachable`."""
        with self._lock:
            targets = [(rep.id, rep.address)
                       for rep in self._replicas.values()
                       if rep.state in ("up", "draining")]
        per, unreachable = {}, []
        for rid, address in sorted(targets):
            try:
                code, _hdrs, body = self.transport.request(
                    address, "GET", "/debug/lifecycle",
                    timeout=max(1.0, self.probe_interval * 4))
                snap = json.loads(body or b"{}")
                if code == 200 and isinstance(snap, dict):
                    per[rid] = snap
                else:
                    unreachable.append(rid)
            except Exception:
                unreachable.append(rid)
        out = {"role": "router", "replicas": per}
        if self.lifecycle is not None:
            out["fleet"] = self.lifecycle.fleet_view()
        if unreachable:
            out["unreachable"] = unreachable
        return out

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def address(self):
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self, probe=True):
        self._serving = True
        self.timeseries.start()
        if probe:
            # one synchronous pass so capacities and readiness reflect
            # the fleet BEFORE the first request can race the loop
            self.probe_once()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, daemon=True,
                name="paddle-tpu-router-probe")
            self._probe_thread.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="paddle-tpu-router")
        self._thread.start()
        return self

    def shutdown(self, drain_timeout=None):
        with self._shutdown_lock:
            first = not self._shutdown_done
            self._shutdown_done = True
        if not first:
            return True
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=2)
        self.timeseries.stop()
        drained = self.admission.drain(timeout=drain_timeout)
        drained = self.gen_admission.drain(timeout=drain_timeout) \
            and drained
        if self._serving:
            self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd.server_close()
        return drained


class _RouterHTTPServer(ThreadingHTTPServer):
    """Same rationale as serving._ServingHTTPServer: the stdlib backlog
    of 5 sheds with raw TCP RSTs under bursts; shedding is the edge
    AdmissionController's decision."""

    request_queue_size = 128
    daemon_threads = True


def _safe_json(data):
    try:
        obj = json.loads(data if isinstance(data, (str, bytes))
                         else b"{}")
        return obj if isinstance(obj, dict) else {"body": obj}
    except ValueError:
        return {"body": repr(data[:200] if data else b"")}
