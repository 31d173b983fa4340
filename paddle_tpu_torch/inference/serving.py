"""HTTP inference server (``paddle_tpu/inference/serving.py``
counterpart): `POST /generate` over the port's continuous-batching
engine, `POST /predict` over a duck-typed predictor.

The module is the JAX package's, with one departure: the JAX server can
load a saved StableHLO model (`model_path=`, `serve(model_path)`,
through `inference.create_predictor`); saved models of the port come
with `torch.export` (ROADMAP Queue A9), so both raise
NotImplementedError here.  A server takes `engine=` (an
`inference.engine.InferenceEngine`, or any engine with its `submit` /
`cancel` / `stats` surface) and / or `predictor=` (anything with
`get_input_names`, `get_output_names` and `run(list of arrays)`).

Threads and the device: the engine runs every device operation (its
prefills, decode steps and CUDA graph captures) on its own loop thread.
The handler threads parse the request into a numpy int32 array, call
the engine's host-side `submit` / `cancel` / `stats` /
`request_debug` / `recent_timelines`, and stream the tokens the loop
thread pushed as Python ints; nothing here reads a device tensor, so a
request or a `/metrics` scrape never synchronizes the card nor touches
a capture in progress (captures are thread-local,
`core/graphs.py`).

Protocol (stdlib-only, zero heavy deps):
  POST /predict   body = .npz archive (numpy savez) with one array per
                  model input, keyed by feed name (or arr_0.. in feed
                  order); response = .npz with one array per fetch name.
  GET  /health    liveness: {"status": "ok", "inputs", "outputs"} while
                  the process is up (including during drain).
  GET  /ready     readiness: 200 while accepting traffic; 503 with a
                  reason while draining or while the last `ready_window`
                  predictor calls ALL failed (load balancers route on
                  this; liveness keeps the process from being killed
                  mid-drain).
  GET  /metrics   Prometheus text exposition: every registry counter/
                  gauge/histogram (cumulative `_bucket{le=...}` series
                  included) plus the `slo.*` gauges — the scrape plane
                  (docs/OBSERVABILITY.md).
  GET  /debug/telemetry   JSON snapshot: metrics, the SLO report
                  (windowed burn rate, shed reasons), admission stats,
                  readiness, recent flight events; over the port's
                  engine also `kernels`: this process's kernel launch
                  counters beside the engine's prefill and decode-step
                  counts.
  GET  /debug/tenants     per-tenant metering: the bounded
                  top-K tenant table + `~other` overflow bucket from the
                  `TenantLedger` — requests by status, prefill tokens
                  computed/saved, decode tokens, decode-slot-ms, KV
                  page-seconds, TTFT/ITL summaries.  This JSON surface
                  is DELIBERATELY not rendered on /metrics (cardinality
                  discipline — docs/OBSERVABILITY.md).
  GET  /debug/lifecycle   this process's spawn-phase record:
                  proc_spawn → imports → weight_load → warmup →
                  announce (→ first_token) with per-phase ms and the
                  per-program compile sub-ledger.

Tenant identity: `X-Tenant-Id` names who to BILL.  Parsed at
the edge next to `X-Request-Id`; a request without one falls back to
`fp:<prefix-fingerprint>` (the X-Prefix-Fingerprint routing hint — the
natural cohort key for a shared-prefix population) and finally to
`anon`, so EVERY request lands in exactly one ledger row.

Request identity (observability/request_trace.py): every /predict
response echoes `X-Request-Id`; incoming `X-Request-Id`/`traceparent`
headers are continued (same id, next hop), bare requests get a minted
id.  Phases — queue wait, admission, predict, serialize — land as
spans on the span tracer (args carry the request id) and as
`serving.phase_ms{phase=...}` histogram observations; the final status
feeds `serving.requests{status}` / `serving.request_ms{status}` and
the per-endpoint `SLOTracker` (sheds with their reason labels).

Status mapping (docs/RESILIENCE.md): deterministic request errors
(wrong dtype/rank/key, undecodable body) → 400; admission sheds and
deadline overruns → 429/503 + `Retry-After`; everything else → 500.

Overload behavior: every request passes the `AdmissionController`
(bounded queue + concurrency limit + deadline-aware shedding, env knobs
`PADDLE_TPU_MAX_INFLIGHT` / `PADDLE_TPU_QUEUE_DEPTH`) BEFORE touching
the predictor lock, so saturation sheds cheap 429s instead of stacking
timeouts.  `shutdown()` is a graceful drain: stop admitting → finish
in-flight (up to `PADDLE_TPU_DRAIN_TIMEOUT`) → close the socket.

Client helper: `InferenceClient` wraps the same protocol with a
configurable timeout and bounded retry on 429/503 honoring Retry-After.
"""
from __future__ import annotations

import io
import json
import math
import os
import queue
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import qos as _qos
from ..observability import lifecycle as _lifecycle
from ..observability import metrics as _metrics
from ..observability import request_trace as _rtrace
from ..observability import tenant_ledger as _tledger
from ..observability import timeseries as _ts
from ..observability import trace as _trace
from ..observability.slo import SLOTracker
from ..resilience.overload import _env_num

__all__ = ["InferenceServer", "InferenceClient", "StreamInterrupted",
           "serve"]

# error classes that cannot be transient: no retry, no batch bisection
_DETERMINISTIC_ERRORS = (TypeError, ValueError, KeyError, IndexError,
                         AttributeError)

_ARR_KEY = re.compile(r"arr_(\d+)$")


# the serving replica's declared timeseries set: the queue /
# batch / token signals whose rates and derivatives answer "how fast is
# pressure growing" — served on GET /debug/timeseries and shipped
# incrementally in exporter dumps.  Bare names sum their label variants.
SERVING_SERIES = (
    "serving.inflight", "serving.queue_depth", "serving.admission_limit",
    "serving.requests", "resilience.shed_requests",
    "engine.active_sequences", "engine.waiting_sequences",
    "engine.batch_occupancy", "engine.page_utilization", "engine.tokens",
)


class _ServingHTTPServer(ThreadingHTTPServer):
    """stdlib default listen backlog is 5: under a connection burst the
    OS sheds with raw TCP RSTs before admission control ever sees the
    request.  Shedding is the AdmissionController's decision (a polite
    429 + Retry-After), so the accept backlog must comfortably exceed
    the admission queue."""

    request_queue_size = 128


def _positional_order(keys):
    """np.savez default keys sorted by NUMERIC suffix: plain
    `sorted()` puts arr_10 before arr_2, silently permuting the feeds
    of any model with more than 10 inputs.  Non-arr_N keys sort after,
    lexicographically (mixed keysets stay deterministic)."""
    def rank(k):
        m = _ARR_KEY.fullmatch(k)
        return (0, int(m.group(1)), k) if m else (1, 0, k)

    return sorted(keys, key=rank)


def _retry_after_header(seconds):
    """HTTP Retry-After is a non-negative INTEGER of seconds."""
    return str(max(0, int(math.ceil(float(seconds)))))


def _kernel_launches(engine) -> dict:
    """This process's kernel launch counters (host ints, no device
    access) beside the engine's prefill and decode-step counts, so a
    caller outside the process holds the launches against the programs
    the engine ran."""
    from ..ops import kernels as _kernels

    return {"launches": _kernels.launch_counts(),
            "prefills": engine.prefill_count,
            "decode_steps": engine.decode_steps,
            "decode_chunk": engine.config.decode_chunk}


class InferenceServer:
    """Serve one predictor. `start()` returns immediately (daemon thread);
    `serve_forever()` blocks. Concurrent requests serialize around the
    predictor (one device queue) via a lock, behind admission control.

    Resilience (docs/RESILIENCE.md): each request runs under a retry
    policy (`request_retries` attempts within the `request_timeout`
    deadline); when retries are exhausted and every input shares a
    splittable leading batch dim, the request DEGRADES — the batch is
    halved recursively (down to single items), halves run independently
    and results re-concatenate, so one poisoned/oversized example costs
    its half-batch a recompile instead of failing the whole request.

    Overload/preemption: `admission` (an
    `resilience.overload.AdmissionController`) gates every request;
    `shutdown()` drains gracefully and is idempotent; pass a
    `resilience.preemption.PreemptionGuard` to `install_preemption()`
    (or let `serve()` do it) and SIGTERM turns into drain-then-exit.
    """

    def __init__(self, model_path=None, host: str = "127.0.0.1",
                 port: int = 0, request_retries: int = 2,
                 request_timeout: float = 30.0, max_inflight=None,
                 queue_depth=None, drain_timeout=None, ready_window=8,
                 predictor=None, engine=None):
        from ..resilience.overload import AdmissionController, ShedError
        from ..resilience.retry import RetryPolicy

        if model_path is not None:
            _saved_models_unported()
        if predictor is not None:
            self._predictor = predictor
        elif engine is None:
            raise ValueError("InferenceServer needs a model_path, a "
                             "predictor, or an engine")
        else:
            self._predictor = None  # generate-only deployment
        # continuous-batching engine behind POST /generate:
        # its OWN AdmissionController, sized to the engine's true
        # capacity (batch slots concurrently decoding, a queue on top)
        # — shedding starts only past actual saturation, not at the
        # predictor lock's conservative default
        self.engine = engine
        # per-tenant metering: adopt the engine's ledger so
        # serving-edge request billing and engine-side token billing
        # share ONE book (conservation is per-book); predict-only
        # deployments get their own.  None when the plane is off —
        # every call site guards, so detached telemetry pays nothing.
        self.tenant_ledger = getattr(engine, "tenant_ledger", None)
        if self.tenant_ledger is None and _tledger.enabled() \
                and _metrics.enabled():
            self.tenant_ledger = _tledger.TenantLedger()
        self.gen_admission = None
        if engine is not None:
            self.gen_admission = AdmissionController(
                max_inflight=engine.config.max_slots,
                queue_depth=queue_depth, name="generate")
        self._plock = threading.Lock()
        self._request_timeout = (None if request_timeout is None
                                 else float(request_timeout))
        self._retry = RetryPolicy(
            "serving", max_attempts=max(1, int(request_retries)),
            base_delay=0.01, max_delay=0.25, deadline=request_timeout,
            # deterministic request errors (wrong dtype/rank for the
            # model) fail identically on every retry AND every split —
            # surface them immediately (no retry, and _run_resilient
            # re-raises them without bisecting the batch)
            give_up_on=_DETERMINISTIC_ERRORS)
        self.admission = AdmissionController(
            max_inflight=max_inflight, queue_depth=queue_depth,
            name="serving")
        # SLO ledger behind /debug/telemetry and the slo.* gauges on
        # /metrics: env knobs so a deployment declares its promise
        # without code (defaults: 1 s latency target, 99.9% availability
        # over a 5-minute window)
        self.slo = SLOTracker(
            window_s=_env_num("PADDLE_TPU_SLO_WINDOW", 300.0, float))
        self.slo.objective(
            "predict",
            latency_target_ms=_env_num("PADDLE_TPU_SLO_LATENCY_MS",
                                       1000.0, float),
            availability=_env_num("PADDLE_TPU_SLO_AVAILABILITY", 0.999,
                                  float))
        if engine is not None:
            # generation is a long-poll stream: the latency objective
            # covers time-to-completion, so default it far laxer than
            # one-shot predict
            self.slo.objective(
                "generate",
                latency_target_ms=_env_num(
                    "PADDLE_TPU_SLO_GENERATE_LATENCY_MS", 30000.0, float),
                availability=_env_num("PADDLE_TPU_SLO_AVAILABILITY",
                                      0.999, float))
            # time-to-first-token is its own SLO phase: at a
            # shared-prefix workload TTFT — not completion time — is
            # what the prefix cache buys, so it gets its own target and
            # burn accounting next to the stream-completion objective
            self.slo.objective(
                "ttft",
                latency_target_ms=_env_num(
                    "PADDLE_TPU_SLO_TTFT_MS", 5000.0, float),
                availability=_env_num("PADDLE_TPU_SLO_AVAILABILITY",
                                      0.999, float))
        # per-class objectives: the PAID class carries its
        # own explicit promise (env-tunable; defaults mirror the
        # endpoint objective) so its burn is tracked against what IT
        # was sold, not the blended fleet average; free/batch inherit
        # the endpoint objective in per-class burn computation
        paid_avail = _env_num("PADDLE_TPU_SLO_PAID_AVAILABILITY",
                              _env_num("PADDLE_TPU_SLO_AVAILABILITY",
                                       0.999, float), float)
        self.slo.objective(
            "predict", cls="paid",
            latency_target_ms=_env_num("PADDLE_TPU_SLO_LATENCY_MS",
                                       1000.0, float),
            availability=paid_avail)
        if engine is not None:
            self.slo.objective(
                "generate", cls="paid",
                latency_target_ms=_env_num(
                    "PADDLE_TPU_SLO_GENERATE_LATENCY_MS", 30000.0,
                    float),
                availability=paid_avail)
        # time-dimension telemetry: a registry sampler for
        # /debug/timeseries (+ exporter dumps), and — for engines — an
        # online ITL/TTFT anomaly watchdog fed at the stream edge
        self.timeseries = _ts.TimeSeriesSampler(names=SERVING_SERIES,
                                                name="serving")
        _ts.set_default_sampler(self.timeseries)
        self.anomalies = _ts.AnomalyDetector() if engine is not None \
            else None
        self._drain_timeout = drain_timeout  # None → env/default in drain()
        self._ready_window = max(1, int(ready_window))
        self._recent = []          # last ready_window predictor outcomes
        self._recent_lock = threading.Lock()
        self._shutdown_lock = threading.Lock()
        self._shutdown_done = False
        self._shutdown_complete = threading.Event()
        self._shutdown_result = True
        self._serving = False
        server = self

        class Handler(BaseHTTPRequestHandler):
            _rt_ctx = None  # the request's RequestContext (POST paths)

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code, obj, headers=()):
                body = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if self._rt_ctx is not None:
                    # EVERY response of an identified request echoes the
                    # id — a shed 429 must correlate like a 200 does
                    self.send_header("X-Request-Id",
                                     self._rt_ctx.request_id)
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    # liveness: up — even while draining (killing a
                    # draining process forfeits its in-flight work)
                    p = server._predictor
                    body = {
                        "status": "ok",
                        "inputs": (p.get_input_names()
                                   if p is not None else []),
                        "outputs": (p.get_output_names()
                                    if p is not None else []),
                        "draining": server.admission.draining,
                    }
                    if server.engine is not None:
                        body["engine"] = server.engine.stats()
                    return self._json(200, body)
                if self.path == "/ready":
                    ready, reason = server.readiness()
                    body = {"status": "ready" if ready else "not_ready",
                            "reason": reason}
                    body.update(server.admission.stats())
                    # router-relevant signals, first-class in the
                    # readiness JSON: before this they were
                    # only recoverable by parsing /metrics text.  The
                    # HTTP status semantics are unchanged — only the
                    # payload grew.
                    body["admission_limit"] = body.get("limit")
                    if server.engine is not None:
                        st = server.engine.stats()
                        body["engine"] = {
                            "batch_occupancy": st.get("occupancy"),
                            "waiting_sequences": st.get("waiting"),
                            "active_sequences": st.get("running"),
                            "max_slots": st.get("max_slots"),
                            # quantized-decode tiers: a
                            # router/operator can see which precision
                            # this replica decodes at without parsing
                            # /metrics text
                            "weight_precision":
                                st.get("weight_precision"),
                            "kv_precision": st.get("kv_precision"),
                            "spec_tokens": st.get("spec_tokens"),
                        }
                        # prefix-cache view: hit rate and
                        # cached tokens first-class in readiness, plus
                        # the physical/logical page split so a router
                        # or operator sees sharing without /metrics
                        # text parsing
                        pc = st.get("prefix_cache") or {}
                        pages = st.get("pages") or {}
                        body["engine"]["prefix_cache"] = {
                            "enabled": pc.get("enabled"),
                            "hit_rate": pc.get("hit_rate"),
                            "cached_tokens": pc.get("cached_tokens"),
                            "tokens_saved_frac":
                                pc.get("tokens_saved_frac"),
                            "shared_pages": pages.get("shared_pages"),
                            "logical_pages": pages.get("logical_pages"),
                        }
                        if server.gen_admission is not None:
                            gs = server.gen_admission.stats()
                            body["engine"]["inflight"] = gs["inflight"]
                            body["engine"]["queued"] = gs["queued"]
                    return self._json(200 if ready else 503, body)
                if self.path == "/metrics":
                    try:
                        text = server.render_metrics()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    body = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4; "
                                     "charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path == "/debug/telemetry":
                    try:
                        snap = server.telemetry_snapshot()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    return self._json(200, snap)
                if self.path == "/debug/tenants":
                    # the per-tenant table's ONLY HTTP surface: JSON
                    # here, never /metrics (a tenant id must not mint
                    # a Prometheus series — docs/OBSERVABILITY.md)
                    if server.tenant_ledger is None:
                        return self._json(
                            404, {"error": "tenant ledger disabled "
                                           "(PADDLE_TPU_TENANT_LEDGER"
                                           "=0 or metrics detached)"})
                    try:
                        body = server.tenant_ledger.snapshot()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    return self._json(200, body)
                if self.path == "/debug/timeseries":
                    try:
                        body = server.timeseries.describe()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    return self._json(200, body)
                if self.path == "/debug/lifecycle":
                    # this process's spawn-phase record:
                    # always answers — a replica that never went
                    # through the fleet spawn path reports its
                    # implicit anchor and whatever phases it stamped
                    try:
                        body = _lifecycle.get_ledger().record()
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    return self._json(200, body)
                if self.path.startswith("/debug/requests/"):
                    rid = self.path[len("/debug/requests/"):]
                    dbg = getattr(server.engine, "request_debug",
                                  None) if server.engine is not None \
                        else None
                    if dbg is None:
                        return self._json(
                            404, {"error": "no engine request "
                                           "timelines on this server"})
                    try:
                        body = dbg(rid)
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    if body is None:
                        return self._json(
                            404, {"error": f"unknown or aged-out "
                                           f"request id {rid!r}"})
                    return self._json(200, body)
                return self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path not in ("/predict", "/generate"):
                    return self._json(404, {"error": "unknown path"})
                # continue the client's identity (or mint one): id
                # echoed on every response below, context active for
                # every span/metric the request touches
                ctx = _rtrace.continue_from_headers(self.headers)
                if ctx.tenant_id is None:
                    # billing fallback chain: no X-Tenant-Id
                    # → derive a cohort key from the prefix-fingerprint
                    # routing hint (tenants sharing a prompt prefix
                    # share a bill), else `anon` — the ledger never
                    # sees an unattributed request
                    fp = self.headers.get("X-Prefix-Fingerprint")
                    tid = _tledger.sanitize_tenant(f"fp:{fp}") \
                        if fp else None
                    ctx.tenant_id = tid or _tledger.ANON_TENANT
                # QoS class resolution: an explicit valid
                # X-Priority-Class wins, else the PADDLE_TPU_QOS_CLASSES
                # tenant→class map, else the default class — resolved
                # ONCE here so admission, the engine scheduler, and the
                # SLO rows below all see the same promise
                ctx.priority_class = _qos.resolve_class(
                    tenant_id=ctx.tenant_id,
                    explicit=ctx.priority_class)
                self._rt_ctx = ctx
                with _rtrace.activate(ctx):
                    if self.path == "/generate":
                        if server.engine is None:
                            return self._json(
                                404, {"error": "no engine attached "
                                               "(generate disabled)"})
                        self._generate_traced(ctx)
                    else:
                        if server._predictor is None:
                            return self._json(
                                404, {"error": "no predictor attached "
                                               "(predict disabled)"})
                        self._predict_traced(ctx)

            def _generate_traced(self, ctx):
                """POST /generate: continuous-batching token streaming.

                Body: JSON ``{"input_ids": [ints] (one sequence),
                "max_new_tokens": int, "eos_token_id": optional int}``.
                Response: 200 + newline-delimited JSON — one
                ``{"token": t}`` line per generated token as the engine
                emits it, then a final ``{"done": true, "output_ids":
                [...], "finish_reason": ...}`` line (connection closes;
                no Content-Length — the stream IS the progress).  Sheds
                and deadline overruns map exactly like /predict
                (429/503 + Retry-After), and a client that disconnects
                mid-stream gets its sequence cancelled so its pages
                return to the pool."""
                t_req = time.perf_counter()
                sp = _trace.begin("serving.generate", cat="serving",
                                  **ctx.trace_args())
                status, slo_reason = "error", "error"
                ticket = None
                handle = None
                try:
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(n) or b"{}")
                        ids = np.asarray(req["input_ids"],
                                         np.int32).reshape(-1)
                        if ids.size < 1:
                            raise ValueError("empty input_ids")
                        max_new = int(req.get("max_new_tokens", 32))
                        eos = req.get("eos_token_id")
                        # mid-stream failover resume: the
                        # router resubmits prompt+delivered under the
                        # same request id; `prebilled_tokens` marks the
                        # verify token the dead replica already billed
                        is_resume = bool(req.get("resume"))
                        prebilled = max(0, int(req.get(
                            "prebilled_tokens", 0)))
                    except Exception as e:
                        status = "client_error"
                        return self._json(
                            400, {"error": f"bad request body: "
                                           f"{type(e).__name__}: {e}"})
                    deadline = (None if server._request_timeout is None
                                else time.monotonic()
                                + server._request_timeout)
                    if ctx.deadline_ms is not None:
                        # the client's own X-Deadline-Ms: the tighter
                        # bound wins (admission refuses work it cannot
                        # finish by then, and reports shed:deadline)
                        client_dl = time.monotonic() \
                            + ctx.deadline_ms / 1e3
                        deadline = (client_dl if deadline is None
                                    else min(deadline, client_dl))
                    try:
                        with _rtrace.request_phase("admission",
                                                   endpoint="generate"):
                            ticket = server.gen_admission.admit(
                                deadline=deadline,
                                priority_class=ctx.priority_class)
                    except ShedError as e:
                        status, slo_reason = "shed", e.reason
                        return self._json(
                            e.http_status,
                            {"error": str(e), "reason": e.reason},
                            headers=[("Retry-After",
                                      _retry_after_header(e.retry_after))])
                    _metrics.observe("serving.phase_ms",
                                     ticket.queue_wait * 1e3,
                                     phase="queue", endpoint="generate")
                    try:
                        handle = server.engine.submit(
                            ids, max_new_tokens=max_new,
                            eos_token_id=eos,
                            request_id=ctx.request_id,
                            tenant_id=ctx.tenant_id,
                            priority_class=ctx.priority_class,
                            deadline=deadline,
                            prebilled_tokens=prebilled)
                    except _DETERMINISTIC_ERRORS as e:
                        status = "client_error"
                        return self._json(
                            400, {"error": f"{type(e).__name__}: {e}"})
                    # headers INSIDE the cancel-on-disconnect guard: a
                    # client that drops before the stream starts must
                    # still free its sequence, not decode max_new
                    # tokens for a dead socket
                    try:
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/x-ndjson")
                        self.send_header("X-Request-Id", ctx.request_id)
                        self.send_header("Connection", "close")
                        self.end_headers()
                        first_at = None
                        last_at = None
                        for tok in handle.stream(
                                timeout=server._request_timeout or 120.0):
                            now = time.perf_counter()
                            if last_at is not None:
                                # inter-token latency at the STREAM
                                # EDGE: what the client
                                # actually waited between tokens —
                                # queue + decode + co-scheduled work,
                                # not just the decode kernel
                                gap_ms = (now - last_at) * 1e3
                                _metrics.observe("serving.itl_ms",
                                                 gap_ms,
                                                 endpoint="generate")
                                if server.anomalies is not None:
                                    server.anomalies.observe("itl",
                                                             gap_ms)
                                if server.tenant_ledger is not None:
                                    server.tenant_ledger.observe_itl(
                                        ctx.tenant_id, gap_ms)
                            last_at = now
                            if first_at is None:
                                # time-to-first-token, labeled by the
                                # prefix-cache outcome: the histogram
                                # that shows what a warm cache buys
                                # (docs/OBSERVABILITY.md)
                                first_at = time.perf_counter()
                                ttft_ms = (first_at - t_req) * 1e3
                                cache_state = getattr(
                                    handle, "cache_state",
                                    "miss") or "miss"
                                _metrics.observe(
                                    "serving.ttft_ms", ttft_ms,
                                    endpoint="generate",
                                    # getattr: engine duck-types
                                    # (ToyEngine) may predate the
                                    # prefix cache — label them miss
                                    cache=cache_state)
                                if is_resume:
                                    # resumed
                                    # streams should tail-prefill off
                                    # the radix index — this label is
                                    # the direct evidence (hit/partial
                                    # = the failover cost only the
                                    # uncached tail)
                                    _metrics.inc(
                                        "serving.resume_prefill",
                                        cache=cache_state)
                                _metrics.observe(
                                    "serving.phase_ms", ttft_ms,
                                    phase="first_token",
                                    endpoint="generate")
                                server.slo.observe(
                                    "ttft", ttft_ms, ok=True,
                                    cls=ctx.priority_class)
                                if server.anomalies is not None:
                                    server.anomalies.observe("ttft",
                                                             ttft_ms)
                                if server.tenant_ledger is not None:
                                    server.tenant_ledger.observe_ttft(
                                        ctx.tenant_id, ttft_ms)
                                # lifecycle: the process's
                                # first-ever emitted token closes the
                                # spawn story (quiet first-wins —
                                # concurrent streams race it
                                # legitimately)
                                _lifecycle.get_ledger().stamp_once(
                                    "first_token")
                            self.wfile.write(
                                json.dumps({"token": int(tok)}).encode()
                                + b"\n")
                            self.wfile.flush()
                        final = {
                            "done": True,
                            "request_id": handle.request_id,
                            "finish_reason": handle.finish_reason,
                            "output_ids":
                                [int(x) for x in
                                 handle.result(timeout=5.0)],
                        }
                        self.wfile.write(json.dumps(final).encode()
                                         + b"\n")
                        self.wfile.flush()
                        status = ("client_error" if handle.cancelled
                                  else "ok")
                    except (BrokenPipeError, ConnectionError, OSError):
                        # the client went away mid-stream: cancel so
                        # the sequence's pages return to the pool
                        server.engine.cancel(handle.request_id)
                        status = "client_error"
                    except queue.Empty:
                        server.engine.cancel(handle.request_id)
                        status, slo_reason = "timeout", "timeout"
                        if first_at is None:
                            # never produced a first token: that is a
                            # TTFT objective failure, not just a
                            # completion failure
                            server.slo.observe(
                                "ttft",
                                (time.perf_counter() - t_req) * 1e3,
                                ok=False, reason="timeout",
                                cls=ctx.priority_class)
                finally:
                    if ticket is not None:
                        ticket.release(ok=status == "ok")
                    dt_ms = (time.perf_counter() - t_req) * 1e3
                    if sp is not None:
                        sp.args["status"] = status
                    _trace.end(sp)
                    _metrics.observe("serving.request_ms", dt_ms,
                                     endpoint="generate", status=status)
                    _metrics.inc("serving.requests", status=status)
                    if server.tenant_ledger is not None:
                        server.tenant_ledger.record_request(
                            ctx.tenant_id, status)
                    server._slo_record(status, slo_reason, dt_ms,
                                       endpoint="generate",
                                       cls=ctx.priority_class)

            def _predict_traced(self, ctx):
                t_req = time.perf_counter()
                sp = _trace.begin("serving.request", cat="serving",
                                  **ctx.trace_args())
                status, slo_reason = "error", "error"
                try:
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        raw = self.rfile.read(n)
                        with np.load(io.BytesIO(raw)) as z:
                            arrays = {k: z[k] for k in z.files}
                    except Exception as e:
                        # undecodable body: the client's fault, always
                        status = "client_error"
                        return self._json(
                            400, {"error": f"bad request body: "
                                           f"{type(e).__name__}: {e}"})
                    try:
                        outs = server.predict(arrays)
                    except ShedError as e:
                        status, slo_reason = "shed", e.reason
                        return self._json(
                            e.http_status,
                            {"error": str(e), "reason": e.reason},
                            headers=[("Retry-After",
                                      _retry_after_header(e.retry_after))])
                    except TimeoutError as e:
                        # DeadlineExceeded is a TimeoutError subclass:
                        # the server ran out of time, not the client out
                        # of line — retryable, with a service-time hint
                        status, slo_reason = "timeout", "timeout"
                        stats = server.admission.stats()
                        hint = stats.get("ewma_latency") or 1.0
                        return self._json(
                            503, {"error": f"{type(e).__name__}: {e}"},
                            headers=[("Retry-After",
                                      _retry_after_header(hint))])
                    except _DETERMINISTIC_ERRORS as e:
                        status = "client_error"
                        return self._json(
                            400, {"error": f"{type(e).__name__}: {e}"})
                    except Exception as e:
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                    with _rtrace.request_phase("serialize"):
                        buf = io.BytesIO()
                        np.savez(buf, **outs)
                        body = buf.getvalue()
                    status = "ok"
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Request-Id", ctx.request_id)
                    self.end_headers()
                    self.wfile.write(body)
                finally:
                    dt_ms = (time.perf_counter() - t_req) * 1e3
                    if sp is not None:
                        sp.args["status"] = status
                    _trace.end(sp)
                    _metrics.observe("serving.request_ms", dt_ms,
                                     endpoint="predict", status=status)
                    _metrics.inc("serving.requests", status=status)
                    if server.tenant_ledger is not None:
                        server.tenant_ledger.record_request(
                            ctx.tenant_id, status)
                    server._slo_record(status, slo_reason, dt_ms,
                                       cls=ctx.priority_class)

        self._httpd = _ServingHTTPServer((host, port), Handler)
        self._thread = None

    @property
    def address(self):
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    # --- readiness -----------------------------------------------------------
    def readiness(self):
        """(ready, reason): not ready while draining, or when the last
        `ready_window` predictor calls ALL failed (a wedged/poisoned
        predictor should shed load balancer traffic, not collect it)."""
        if self.admission.draining:
            return False, "draining"
        with self._recent_lock:
            recent = list(self._recent)
        if len(recent) >= self._ready_window and not any(recent):
            return False, "predictor_failing"
        return True, "ok"

    def _note_outcome(self, ok):
        with self._recent_lock:
            self._recent.append(bool(ok))
            del self._recent[:-self._ready_window]

    # --- telemetry plane -----------------------------------------------------
    def _slo_record(self, status, reason, latency_ms,
                    endpoint="predict", cls=None):
        """Feed the SLO ledger with one finished request.  Client-fault
        400s (and mid-stream disconnects) are excluded — the
        availability objective is a promise about the SERVER, and one
        misbehaving client must not page the on-call for it (mirror of
        the readiness-window rule above)."""
        if status == "ok":
            self.slo.observe(endpoint, latency_ms, ok=True, cls=cls)
        elif status == "shed":
            self.slo.record_shed(endpoint, reason, cls=cls)
        elif status in ("timeout", "error"):
            self.slo.observe(endpoint, latency_ms, ok=False,
                             reason=reason, cls=cls)

    def render_metrics(self) -> str:
        """Prometheus text for GET /metrics (refreshes the slo.* gauges
        first so the scrape carries the current burn rate)."""
        self.slo.report()
        return _metrics.to_prometheus()

    def telemetry_snapshot(self) -> dict:
        """JSON body of GET /debug/telemetry: the one-stop in-process
        view — metrics snapshot, SLO report, admission stats,
        readiness, and the recent flight ring."""
        from ..observability import flight as _flight

        ready, reason = self.readiness()
        # SLO report first: it publishes the slo.* gauges the metrics
        # snapshot should carry (same ordering as the exporter)
        slo_report = self.slo.report()
        snap = {
            "t": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "pid": os.getpid(),
            "metrics": _metrics.snapshot(),
            "slo": slo_report,
            "admission": self.admission.stats(),
            "readiness": {"ready": ready, "reason": reason},
            "flight": _flight.events()[-64:],
        }
        snap["timeseries"] = self.timeseries.stats()
        # this process's spawn-phase record — the same body
        # GET /debug/lifecycle serves
        snap["lifecycle"] = _lifecycle.get_ledger().record()
        if self.tenant_ledger is not None:
            snap["tenants"] = self.tenant_ledger.snapshot()
        if self.anomalies is not None:
            snap["anomalies"] = self.anomalies.report()
        if self.engine is not None:
            # the engine's full view — including the prefix-cache
            # ledger and the shared/logical page split
            snap["engine"] = self.engine.stats()
            # recent per-request latency timelines: the
            # summary rows; full gap attribution lives behind
            # GET /debug/requests/<id>
            tls = getattr(self.engine, "recent_timelines", None)
            if tls is not None:
                snap["request_timelines"] = tls()
            if hasattr(self.engine, "decode_steps"):
                snap["kernels"] = _kernel_launches(self.engine)
        return snap

    # --- request path --------------------------------------------------------
    def predict(self, arrays: dict) -> dict:
        p = self._predictor
        feed_order = p.get_input_names()
        if set(arrays) >= set(feed_order):
            inputs = [arrays[n] for n in feed_order]
        else:  # positional arr_0, arr_1, ... (np.savez default keys)
            inputs = [arrays[k] for k in _positional_order(arrays)]
        deadline = (None if self._request_timeout is None
                    else time.monotonic() + self._request_timeout)
        # QoS: class + client deadline ride the request
        # context — do_POST resolved the class once; direct callers
        # (tests, in-process use) resolve here from the tenant map
        ctx = _rtrace.current()
        cls = _qos.resolve_class(
            tenant_id=None if ctx is None else ctx.tenant_id,
            explicit=None if ctx is None else ctx.priority_class)
        if ctx is not None and ctx.deadline_ms is not None:
            client_dl = time.monotonic() + ctx.deadline_ms / 1e3
            deadline = (client_dl if deadline is None
                        else min(deadline, client_dl))
        # phase breakdown: "admission" spans the admit call
        # (decision + queue camp; the camp itself is the controller's
        # own nested `serving.queue` span), "queue" is observed from
        # the measured wait, "predict" spans the resilient run
        with _rtrace.request_phase("admission") as asp:
            ticket = self.admission.admit(deadline=deadline,
                                          priority_class=cls)
            if asp is not None:
                asp.args["queue_wait_ms"] = round(
                    ticket.queue_wait * 1e3, 3)
        _metrics.observe("serving.phase_ms", ticket.queue_wait * 1e3,
                         phase="queue", endpoint="predict")
        ok = None  # None = client-fault outcome: readiness unaffected
        try:
            with _rtrace.request_phase("predict"):
                outs = self._run_resilient(inputs, _deadline=deadline)
            ok = True
        except _DETERMINISTIC_ERRORS:
            # the CLIENT's request was wrong (400) — feeding this into
            # the readiness window would let one misbehaving client
            # flip a healthy server to not-ready
            raise
        except Exception:
            ok = False
            raise
        finally:
            if ok is not None:
                self._note_outcome(ok)
            ticket.release(ok=bool(ok))
        return {n: np.asarray(v)
                for n, v in zip(p.get_output_names(), outs)}

    def _run_once(self, inputs):
        from ..resilience import faults as _faults

        _faults.fire("serving.request",
                     batch=int(np.shape(inputs[0])[0])
                     if inputs and np.ndim(inputs[0]) else 0)
        with self._plock:
            return self._predictor.run(inputs)

    def _run_resilient(self, inputs, _depth=0, _deadline=None):
        """Retry, then degrade-to-smaller-batch: split the batch in half
        and serve each half independently (recursive, so a single bad
        example bounds the blast radius to itself).  `request_timeout`
        bounds the WHOLE request including the split tree — a wedged
        predictor fails the request once, not once per half."""
        import time as _time

        if _deadline is None and self._request_timeout is not None:
            _deadline = _time.monotonic() + self._request_timeout
        if _deadline is not None and _time.monotonic() > _deadline:
            raise TimeoutError(
                f"serving request exceeded its {self._request_timeout}s "
                f"deadline while degrading (depth {_depth})")
        try:
            return self._retry.call(self._run_once, inputs)
        except _DETERMINISTIC_ERRORS:
            raise  # same failure at any batch size — don't bisect
        except Exception:
            bs = {int(np.shape(x)[0]) for x in inputs if np.ndim(x) > 0}
            if _depth >= 8 or len(bs) != 1 or next(iter(bs)) < 2 or (
                    _deadline is not None
                    and _time.monotonic() > _deadline):
                raise  # nothing left to split — surface the real error
            n = next(iter(bs))
            self._note_degrade(n, _depth)

            def half(sl):
                # scalars/0-d inputs ride along unsliced
                return [x[sl] if np.ndim(x) > 0 else x for x in inputs]

            lo = self._run_resilient(half(slice(None, n // 2)),
                                     _depth + 1, _deadline)
            hi = self._run_resilient(half(slice(n // 2, None)),
                                     _depth + 1, _deadline)
            return [np.concatenate([np.asarray(a), np.asarray(b)], axis=0)
                    for a, b in zip(lo, hi)]

    @staticmethod
    def _note_degrade(batch, depth):
        try:
            from ..observability import flight as _flight
            from ..observability import metrics as _metrics

            _metrics.inc("resilience.degraded_batches")
            _flight.record("resilience.serving_degrade", batch=batch,
                           depth=depth)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: _note_degrade
            # runs inside _run_resilient's recovery handler — a
            # telemetry error escaping here would abort the
            # degrade-to-smaller-batch recursion and fail the request)

    # --- lifecycle -----------------------------------------------------------
    def start(self):
        # pt-lint: ok[PT503] (ordered flag: set True before the serving thread exists, cleared only by shutdown(); a torn read is impossible for a bool and a stale one only delays the drain a poll)
        self._serving = True  # before the thread runs: a shutdown()
        # racing start() must wait for the loop, not skip it
        if self.engine is not None:
            self.engine.start()
        self.timeseries.start()
        # pt-lint: ok[PT503] (set-once before the thread starts; shutdown() only joins it — CPython attribute store is atomic)
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True,
            name="paddle-tpu-serving")
        self._thread.start()
        return self

    def serve_forever(self):
        self._serving = True
        if self.engine is not None:
            self.engine.start()  # idempotent
        self.timeseries.start()  # idempotent
        self._httpd.serve_forever()

    def install_preemption(self, guard=None, install_signals=True):
        """Wire a `PreemptionGuard`: SIGTERM/SIGINT (or a maintenance
        event) begins the drain immediately, and the full graceful
        shutdown runs on a helper thread — `shutdown()` must never run
        inline in signal context on the thread running serve_forever()
        (it would deadlock waiting for its own loop to exit)."""
        from ..resilience.preemption import PreemptionGuard

        guard = guard or PreemptionGuard()
        if install_signals:
            guard.install()

        def _drain(reason):
            self.admission.begin_drain()  # readiness flips NOW
            threading.Thread(target=self.shutdown, daemon=True,
                             name="paddle-tpu-serving-drain").start()

        guard.on_preempt(_drain)
        self._preemption_guard = guard
        return guard

    def shutdown(self, drain_timeout=None):
        """Graceful drain: stop admitting (queued requests shed 503,
        readiness flips), finish in-flight requests up to the drain
        deadline, stop the accept loop, CLOSE the listening socket.
        Idempotent AND blocking — launcher teardown racing a signal
        handler's drain thread is the normal case, and the loser must
        WAIT for the winner's drain, not return early and let the
        process exit with requests still in flight.  Returns True when
        the drain completed before the deadline."""
        with self._shutdown_lock:
            first = not self._shutdown_done
            self._shutdown_done = True
        if not first:
            # another caller is (or was) draining: ride its result —
            # and if IT has not finished inside our wait budget, say so
            # (True here would green-light a process exit with requests
            # still in flight)
            budget = drain_timeout if drain_timeout is not None \
                else self._drain_timeout
            if budget is None:
                budget = 30.0
            finished = self._shutdown_complete.wait(
                timeout=float(budget) + 10.0)
            return bool(finished and self._shutdown_result)
        try:
            if drain_timeout is None:
                drain_timeout = self._drain_timeout
            t_drain = time.monotonic()
            drained = self.admission.drain(timeout=drain_timeout)
            if self.gen_admission is not None:
                # generate streams drain on the SAME budget, not a
                # second one: an orchestrator's kill grace period is
                # sized to one drain_timeout, so the
                # second controller gets whatever is left of it
                budget = drain_timeout if drain_timeout is not None \
                    else _env_num("PADDLE_TPU_DRAIN_TIMEOUT", 30.0,
                                  float)
                remaining = max(
                    0.0, float(budget) - (time.monotonic() - t_drain))
                drained = self.gen_admission.drain(
                    timeout=remaining) and drained
            if self.engine is not None:
                self.engine.stop()
            # one last sample so the final exporter dump carries the
            # drained end state, then stop the sampling thread
            try:
                self.timeseries.sample()
            except Exception:  # pt-lint: ok[PT005]
                pass           # (observability fan-out guard: shutdown
                # must never raise)
            self.timeseries.stop()
            try:
                from ..observability import flight as _flight
                from ..observability import metrics as _metrics

                _metrics.inc("preemption.drains")
                _flight.record("serving.drained", complete=bool(drained))
            except Exception:  # pt-lint: ok[PT005]
                pass           # (observability fan-out guard: shutdown
                # runs in signal/atexit paths and must never raise)
            if self._serving:  # shutdown() on a never-started server
                self._httpd.shutdown()  # must not block on a loop
                # that never ran
            if self._thread is not None:
                self._thread.join(timeout=5)
            # the listening socket used to leak here: without
            # server_close() the fd (and the port) stayed held for the
            # process lifetime
            self._httpd.server_close()
            self._shutdown_result = drained
        finally:
            self._shutdown_complete.set()
        return self._shutdown_result


class StreamInterrupted(RuntimeError):
    """A /generate stream was cleanly cut after tokens were already
    delivered (the serving replica died mid-stream behind a router, or
    the engine cancelled the sequence).  Carries the resumable state:
    `output_ids` is the prompt + every token delivered so far — resubmit
    it as the next request's `input_ids` to continue the generation
    without replaying a single token.  `tokens` is just the delivered
    generated tokens; `finish_reason` names the cut."""

    def __init__(self, message, output_ids=None, tokens=(),
                 finish_reason="interrupted", request_id=None,
                 tenant_id=None):
        super().__init__(message)
        self.output_ids = (None if output_ids is None
                           else np.asarray(output_ids, np.int32))
        self.tokens = list(tokens)
        self.finish_reason = finish_reason
        self.request_id = request_id
        # who was being billed when the stream cut: the
        # caller resubmitting the resumable prefix keeps ONE tenant
        # identity across the interruption
        self.tenant_id = tenant_id


class InferenceClient:
    """Protocol client with a configurable timeout and bounded retry on
    429/503 honoring the server's Retry-After header (capped at
    `max_retry_wait` so a confused server cannot park the client)."""

    def __init__(self, address: str, timeout: float = 120.0,
                 retries: int = 2, max_retry_wait: float = 5.0,
                 sleep=time.sleep, fingerprint_tokens: int = 64,
                 tenant_id=None, priority_class=None, deadline_ms=None):
        self.address = address.rstrip("/")
        self.timeout = float(timeout)
        self.retries = max(0, int(retries))
        self.max_retry_wait = float(max_retry_wait)
        self.sleep = sleep
        # billing identity: stamped as X-Tenant-Id on every
        # request this client sends.  Validated HERE, loudly — a typo'd
        # tenant silently degrading to `anon` would misbill forever.
        if tenant_id is not None \
                and _tledger.sanitize_tenant(tenant_id) is None:
            raise ValueError(
                f"invalid tenant_id {tenant_id!r}: want 1-64 chars of "
                f"[A-Za-z0-9._:-]")
        self.tenant_id = (None if tenant_id is None
                          else str(tenant_id))
        # QoS identity: stamped as X-Priority-Class /
        # X-Deadline-Ms.  Same validate-loudly rule as tenant_id — a
        # typo'd class silently degrading to the default tier would
        # mis-serve forever.
        if priority_class is not None \
                and _qos.normalize_class(priority_class) is None:
            raise ValueError(
                f"invalid priority_class {priority_class!r}: want one "
                f"of {_qos.CLASSES}")
        self.priority_class = (None if priority_class is None
                               else _qos.normalize_class(priority_class))
        self.deadline_ms = (None if deadline_ms is None
                            else int(deadline_ms))
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"invalid deadline_ms {deadline_ms!r}: want a positive "
                f"millisecond budget")
        # prefix-affinity fingerprint length: generate()
        # sends a cheap hash of the first N page-aligned prompt tokens
        # so a router can keep repeat tenants where their prefix cache
        # lives.  0 disables the header.
        self.fingerprint_tokens = max(0, int(fingerprint_tokens))

    @staticmethod
    def prefix_fingerprint(input_ids, tokens: int = 64,
                           granule: int = 16):
        """Hex fingerprint of the first `tokens` PAGE-ALIGNED prompt
        ids (floored to a `granule` multiple — the default engine page
        size — so two prompts sharing a cacheable prefix fingerprint
        alike).  Purely a ROUTING hint: the engine's radix index
        matches real token values, so a poisoned/mismatched
        fingerprint can at worst cost a cache miss, never a
        wrong-token stream.  Returns None for prompts too short to
        share a page."""
        import hashlib

        ids = np.asarray(input_ids, np.int64).reshape(-1)
        n = min(int(tokens), (ids.size // granule) * granule)
        if n <= 0:
            return None
        return hashlib.sha1(ids[:n].tobytes()).hexdigest()[:16]

    def health(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(self.address + "/health",
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    def ready(self) -> dict:
        """Readiness probe: {"ready": bool, ...server stats}.  A 503 is
        a VALID readiness answer, not an error."""
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.address + "/ready",
                                        timeout=self.timeout) as r:
                body = json.loads(r.read())
                code = r.status
        except urllib.error.HTTPError as e:
            body = json.loads(e.read() or b"{}")
            code = e.code
        body["ready"] = code == 200
        return body

    def _retry_wait(self, headers):
        """Defensive Retry-After parse: the header
        is server-controlled input that feeds straight into sleep
        math — a non-numeric value, a negative, a NaN (which poisons
        min/max comparisons and would crash time.sleep), or an absurd
        1e9 must all collapse into a bounded wait, never an exception
        and never an unbounded park.  The parsed value is clamped into
        [0, max_retry_wait]; the final wait keeps the 50 ms floor so a
        Retry-After of 0 backs off instead of busy-spinning."""
        try:
            ra = float(headers.get("Retry-After", 0.5))
        except (TypeError, ValueError):
            ra = 0.5
        if not math.isfinite(ra):
            ra = 0.5
        return min(max(ra, 0.05), self.max_retry_wait)

    def generate(self, input_ids, max_new_tokens=32, eos_token_id=None,
                 on_token=None, resume=False) -> dict:
        """Stream one sequence through POST /generate.

        Tokens are consumed INCREMENTALLY off the ndjson stream —
        `on_token(tok)` (optional) fires for each as it arrives, before
        the generation finishes.  Returns the final record:
        ``{"output_ids": np.int32 array, "tokens": [...],
        "finish_reason": ..., "request_id": ..., "resumed": n}``
        (`resumed` counts router-side mid-stream failovers this stream
        absorbed — 0 on the common path).

        Retry discipline: ONE request identity is minted
        BEFORE the retry loop — a 429/503 shed retries under the same
        `X-Request-Id` (honoring Retry-After, capped), so server spans
        and the engine's sequence correlate every attempt.  Sheds can
        only happen before the stream starts (the status line is the
        admission decision), so retrying never replays tokens.

        With ``resume=True``: a
        `StreamInterrupted` — the router's resume-EXHAUSTED fallback —
        is absorbed by re-issuing the carried `output_ids` prefix as
        the next leg's prompt under the SAME request id, with
        `max_new_tokens` reduced by what already arrived (the greedy
        determinism contract makes the delivered tokens the prompt's
        true continuation).  Bounded by `PADDLE_TPU_STREAM_RESUME_MAX`
        legs; when the budget runs out the final `StreamInterrupted`
        propagates carrying the FULL merged token prefix."""
        ids = [int(x) for x in np.asarray(input_ids).reshape(-1)]
        max_new = int(max_new_tokens)
        amb = _rtrace.current()
        ctx = amb.child() if amb is not None else _rtrace.new_context()
        if ctx.tenant_id is None and self.tenant_id is not None:
            # one tenant identity minted BEFORE the retry loop (same
            # discipline as X-Request-Id): every attempt of one request
            # bills the same ledger row.  An ambient hop's tenant wins —
            # re-stamping mid-chain would split one request's bill.
            ctx.tenant_id = self.tenant_id
        if ctx.priority_class is None and self.priority_class is not None:
            ctx.priority_class = self.priority_class  # ambient hop wins
        if ctx.deadline_ms is None and self.deadline_ms is not None:
            ctx.deadline_ms = self.deadline_ms
        legs = (_env_num("PADDLE_TPU_STREAM_RESUME_MAX", 2, int)
                if resume else 0)
        legs_used = 0
        prior: list = []           # tokens delivered by earlier legs
        cur_ids, cur_max = ids, max_new
        while True:
            try:
                out = self._generate_attempt(cur_ids, cur_max,
                                             eos_token_id, on_token,
                                             ctx)
            except StreamInterrupted as e:
                delivered = list(e.tokens)
                if legs_used >= legs or e.output_ids is None:
                    # resume off / budget spent: surface the FULL
                    # merged resumable prefix, not just this leg's
                    e.tokens = prior + delivered
                    raise
                legs_used += 1
                prior.extend(delivered)
                cur_ids = [int(x) for x in e.output_ids]
                cur_max = cur_max - len(delivered)
                if cur_max < 1:
                    # every budgeted token already arrived; only the
                    # final record was lost — synthesize it (greedy
                    # contract: the delivered prefix IS the answer)
                    return {
                        "output_ids": np.asarray(cur_ids, np.int32),
                        "tokens": prior,
                        "finish_reason": "length",
                        "request_id": e.request_id or ctx.request_id,
                        "tenant_id": ctx.tenant_id,
                        "resumed": legs_used,
                    }
                continue
            out["tokens"] = prior + out["tokens"]
            out["resumed"] = int(out.get("resumed", 0) or 0) + legs_used
            return out

    def _generate_attempt(self, ids, max_new_tokens, eos_token_id,
                          on_token, ctx) -> dict:
        """One /generate leg under an existing request identity: the
        body of one resume leg.  Raises StreamInterrupted with
        THIS leg's delivered tokens; generate() merges legs."""
        import urllib.error
        import urllib.request

        body = {"input_ids": [int(x) for x in ids],
                "max_new_tokens": int(max_new_tokens)}
        if eos_token_id is not None:
            body["eos_token_id"] = int(eos_token_id)
        data = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        headers.update(ctx.to_headers())
        if self.fingerprint_tokens:
            fp = self.prefix_fingerprint(body["input_ids"],
                                         self.fingerprint_tokens)
            if fp is not None:
                headers["X-Prefix-Fingerprint"] = fp
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(
                self.address + "/generate", data=data, headers=headers)
            sp = _trace.begin("client.generate", cat="client",
                             attempt=attempt, **ctx.trace_args())
            t0 = time.perf_counter()
            status = "error"
            retry_wait = None
            final = None
            try:
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout) as r:
                        tokens = []
                        for line in r:
                            line = line.strip()
                            if not line:
                                continue
                            evt = json.loads(line)
                            if evt.get("done"):
                                final = evt
                                break
                            if evt.get("interrupted"):
                                # a router cut the stream cleanly after
                                # tokens were delivered: surface the
                                # resumable prefix — NEVER silently
                                # retry (a replay would duplicate the
                                # delivered tokens)
                                status = "interrupted"
                                raise StreamInterrupted(
                                    evt.get("error",
                                            "stream interrupted"),
                                    output_ids=evt.get("output_ids"),
                                    tokens=tokens,
                                    finish_reason=evt.get(
                                        "finish_reason", "interrupted"),
                                    request_id=evt.get("request_id"),
                                    tenant_id=ctx.tenant_id)
                            tokens.append(int(evt["token"]))
                            if on_token is not None:
                                on_token(int(evt["token"]))
                    if final is None:
                        raise RuntimeError(
                            "generate stream ended without a final "
                            "record (server cancelled?)")
                    status = "ok"
                except urllib.error.HTTPError as e:
                    if e.code in (429, 503) and attempt < self.retries:
                        status = "shed_retry"
                        retry_wait = self._retry_wait(e.headers)
                    else:
                        raise
            finally:
                if sp is not None:
                    sp.args["status"] = status
                _trace.end(sp)
                _metrics.observe("client.request_ms",
                                 (time.perf_counter() - t0) * 1e3,
                                 status=status)
                _metrics.inc("client.requests", status=status)
            if retry_wait is not None:
                self.sleep(retry_wait)
                continue
            return {
                "output_ids": np.asarray(final["output_ids"], np.int32),
                "tokens": tokens,
                "finish_reason": final.get("finish_reason"),
                "request_id": final.get("request_id"),
                "tenant_id": ctx.tenant_id,
                # router-side mid-stream failovers absorbed:
                # 0 on the common path, stamped on the final record by
                # the router when a resume leg served part of the stream
                "resumed": int(final.get("resumed", 0) or 0),
            }

    def predict(self, *arrays, **named) -> dict:
        import urllib.error
        import urllib.request

        buf = io.BytesIO()
        if named:
            np.savez(buf, **named)
        else:
            np.savez(buf, *arrays)
        data = buf.getvalue()
        # ONE identity for the whole request, minted BEFORE the retry
        # loop: a 429'd request retries under the same X-Request-Id, so
        # server-side spans/logs correlate every attempt.  An ambient
        # context (this client called from inside another traced
        # request) continues as the next hop instead of starting over.
        amb = _rtrace.current()
        ctx = amb.child() if amb is not None else _rtrace.new_context()
        if ctx.tenant_id is None and self.tenant_id is not None:
            ctx.tenant_id = self.tenant_id  # one identity, all attempts
        if ctx.priority_class is None and self.priority_class is not None:
            ctx.priority_class = self.priority_class  # ambient hop wins
        if ctx.deadline_ms is None and self.deadline_ms is not None:
            ctx.deadline_ms = self.deadline_ms
        headers = {"Content-Type": "application/octet-stream"}
        headers.update(ctx.to_headers())
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(
                self.address + "/predict", data=data, headers=headers)
            sp = _trace.begin("client.predict", cat="client",
                              attempt=attempt, **ctx.trace_args())
            t0 = time.perf_counter()
            status = "error"
            payload = None
            retry_wait = None
            try:
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout) as r:
                        payload = r.read()
                    status = "ok"
                except urllib.error.HTTPError as e:
                    if e.code in (429, 503) and attempt < self.retries:
                        # the backoff sleep happens AFTER the span and
                        # latency observation close: client.request_ms
                        # measures the HTTP attempt, not the deliberate
                        # wait between attempts
                        status = "shed_retry"
                        retry_wait = self._retry_wait(e.headers)
                    else:
                        raise
            finally:
                if sp is not None:
                    sp.args["status"] = status
                _trace.end(sp)
                _metrics.observe("client.request_ms",
                                 (time.perf_counter() - t0) * 1e3,
                                 status=status)
                _metrics.inc("client.requests", status=status)
            if retry_wait is not None:
                self.sleep(retry_wait)
                continue
            with np.load(io.BytesIO(payload)) as z:
                return {k: z[k] for k in z.files}


def _saved_models_unported():
    raise NotImplementedError(
        "serving a saved model (model_path=, serve(model_path)) is not "
        "ported yet (ROADMAP Queue A9: saved models through torch.export);"
        " pass engine= or predictor= to InferenceServer")


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8866):
    """Blocking entry point of the JAX package's saved-model server.
    Raises NotImplementedError: saved models of the port come with
    `torch.export` (ROADMAP Queue A9).  To serve an engine, build
    `InferenceServer(engine=...)` or run a fleet replica
    (`python -m paddle_tpu_torch.inference.fleet --replica ...`)."""
    _saved_models_unported()
