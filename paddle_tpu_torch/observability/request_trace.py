"""Request-level tracing: per-request identity + cross-hop propagation.

The serving plane needs every request to be ONE story across
processes: the client stamps a request id and a traceparent, the server
extracts them, and every span/metric/log either side emits carries the
same identity — so the merged fleet timeline (`tools/telemetry_agg.py`)
shows one request's queue/admission/predict/serialize phases on both
processes' tracks, and a 500 in the server log joins the client attempt
that saw it.

Pieces:
  * `RequestContext` — request id (the operator-facing correlation key,
    echoed as `X-Request-Id`) + W3C-traceparent-style trace/span ids
    and a hop counter.  `child()` derives the next hop (new span id,
    parent recorded) — what a router or a server calling a downstream
    model does before re-injecting headers.
  * contextvar plumbing — `activate(ctx)` scopes a context to the
    current task/thread; `current()` reads it anywhere below (the
    admission controller tags its queue spans without serving passing
    the context through every call).
  * header codec — `to_headers()` / `from_headers()` speak
    `X-Request-Id` plus `traceparent` (`00-<trace>-<span>-01`), so any
    W3C-compatible edge in front of the fleet keeps the chain intact.
  * `request_phase(...)` — the per-phase measurement idiom: a span on
    the `SpanTracer` (args carry the request identity) AND a
    `serving.phase_ms{phase=...,endpoint=...}` histogram observation on
    the shared registry.

stdlib-only (contextvars, uuid) and import-cycle-free like the rest of
`observability/`; the metrics/trace integration is guarded so the
module also works file-loaded standalone.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
import time
import uuid

__all__ = [
    "RequestContext", "new_context", "current", "activate",
    "continue_from_headers", "request_phase", "HEADER_REQUEST_ID",
    "HEADER_TRACEPARENT", "HEADER_TENANT_ID", "HEADER_PRIORITY_CLASS",
    "HEADER_DEADLINE_MS",
]

HEADER_REQUEST_ID = "X-Request-Id"
HEADER_TRACEPARENT = "traceparent"
# tenant identity: who to BILL, carried hop-to-hop next to
# who to TRACE — the router's shed for a tenant and the replica's
# decode for the same tenant land in one ledger row
HEADER_TENANT_ID = "X-Tenant-Id"
# QoS identity: what was PROMISED, carried hop-to-hop next
# to who to bill — the edge's shed ordering, the scheduler's
# preemption ladder, and the per-class SLO rows all read the same
# class the client stamped (or the tenant→class map resolved)
HEADER_PRIORITY_CLASS = "X-Priority-Class"
HEADER_DEADLINE_MS = "X-Deadline-Ms"

# 00-<32 hex trace id>-<16 hex span id>-<2 hex flags>
_TRACEPARENT = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
# request ids are echoed into headers and filenames: keep them tame
_REQUEST_ID = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")
# tenant ids are ledger keys and debug-table rows: same discipline
# (mirrors tenant_ledger._TENANT_ID — this module stays standalone)
_TENANT_ID = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")
# priority classes are metric labels: closed set, validate-or-drop
# (mirrors inference.qos.CLASSES — this module stays standalone)
_PRIORITY_CLASSES = frozenset(("paid", "free", "batch"))
# deadlines are milliseconds-from-now; clamp keeps a hostile header
# from minting a year-long admission estimate window
_DEADLINE_MAX_MS = 3_600_000

_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_request", default=None)


def _norm_class(value):
    """Validate-or-drop for `X-Priority-Class`: a known class name or
    None.  A garbage class must not mint a garbage metric label."""
    if value is None:
        return None
    v = str(value).strip().lower()
    return v if v in _PRIORITY_CLASSES else None


def _norm_deadline_ms(value):
    """Validate-or-drop for `X-Deadline-Ms`: a positive integer number
    of milliseconds (clamped), or None."""
    if value is None:
        return None
    try:
        ms = int(str(value).strip())
    except (TypeError, ValueError):
        return None
    if ms <= 0:
        return None
    return min(ms, _DEADLINE_MAX_MS)


def _obs_modules():
    """(metrics, trace) from the observability package, or Nones when
    file-loaded standalone."""
    try:
        from . import metrics, trace  # type: ignore

        return metrics, trace
    except ImportError:
        return None, None


class RequestContext:
    """One request's identity at one hop.  Immutable by convention —
    `child()` derives the next hop instead of mutating this one."""

    __slots__ = ("request_id", "trace_id", "span_id", "parent_id",
                 "hop", "tenant_id", "priority_class", "deadline_ms")

    def __init__(self, request_id=None, trace_id=None, span_id=None,
                 parent_id=None, hop=0, tenant_id=None,
                 priority_class=None, deadline_ms=None):
        self.request_id = str(request_id) if request_id \
            else uuid.uuid4().hex[:16]
        self.trace_id = str(trace_id) if trace_id else uuid.uuid4().hex
        self.span_id = str(span_id) if span_id else uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.hop = int(hop)
        # billing identity: None means "not established at
        # this hop yet" — the serving edge resolves a fallback (prefix
        # fingerprint, else anon) and every hop below inherits it
        tid = str(tenant_id) if tenant_id is not None else None
        self.tenant_id = tid if tid and _TENANT_ID.match(tid) else None
        # QoS identity: None means "not resolved yet" — the
        # first edge resolves tenant→class (qos.resolve_class) and
        # every hop below inherits the resolved class
        self.priority_class = _norm_class(priority_class)
        self.deadline_ms = _norm_deadline_ms(deadline_ms)

    def child(self) -> "RequestContext":
        """The next hop: same request/trace/tenant/QoS identity, fresh
        span id, this hop's span recorded as the parent."""
        return RequestContext(request_id=self.request_id,
                              trace_id=self.trace_id,
                              parent_id=self.span_id, hop=self.hop + 1,
                              tenant_id=self.tenant_id,
                              priority_class=self.priority_class,
                              deadline_ms=self.deadline_ms)

    def to_headers(self) -> dict:
        h = {
            HEADER_REQUEST_ID: self.request_id,
            HEADER_TRACEPARENT: f"00-{self.trace_id}-{self.span_id}-01",
        }
        if self.tenant_id:
            h[HEADER_TENANT_ID] = self.tenant_id
        if self.priority_class:
            h[HEADER_PRIORITY_CLASS] = self.priority_class
        if self.deadline_ms is not None:
            h[HEADER_DEADLINE_MS] = str(self.deadline_ms)
        return h

    def trace_args(self) -> dict:
        """Span args carrying the identity (what every phase span and
        instant attaches so the merged timeline joins on request_id)."""
        args = {"request_id": self.request_id, "trace_id": self.trace_id,
                "span_id": self.span_id, "hop": self.hop}
        if self.parent_id:
            args["parent_span_id"] = self.parent_id
        if self.tenant_id:
            args["tenant_id"] = self.tenant_id
        if self.priority_class:
            args["priority_class"] = self.priority_class
        if self.deadline_ms is not None:
            args["deadline_ms"] = self.deadline_ms
        return args

    def to_dict(self) -> dict:
        return self.trace_args()

    def __repr__(self):
        return (f"RequestContext(request_id={self.request_id!r}, "
                f"hop={self.hop})")

    @classmethod
    def from_headers(cls, headers):
        """Parse an incoming hop from an HTTP header mapping (any object
        with `.get`; `http.server`'s message headers are
        case-insensitive, plain dicts are probed under both casings).
        Returns None when no usable identity is present — a malformed
        traceparent with a valid request id still yields a context (the
        correlation key is the part operators grep for)."""
        def get(name):
            v = headers.get(name)
            if v is None and hasattr(headers, "get"):
                v = headers.get(name.lower()) or headers.get(name.title())
            return v

        rid = get(HEADER_REQUEST_ID)
        if rid is not None and not _REQUEST_ID.match(str(rid)):
            rid = None  # hostile/garbage id: mint our own
        tid = get(HEADER_TENANT_ID)
        if tid is not None and not _TENANT_ID.match(str(tid)):
            tid = None  # hostile/garbage tenant: treat as unset — the
            # edge's fallback derivation owns it from here (a garbage
            # header must not mint a garbage ledger key)
        # QoS headers: validate-or-drop like every identity header (a
        # garbage class/deadline degrades to "unset", never to a 4xx
        # and never to a garbage label)
        pcls = _norm_class(get(HEADER_PRIORITY_CLASS))
        dms = _norm_deadline_ms(get(HEADER_DEADLINE_MS))
        tp = get(HEADER_TRACEPARENT)
        m = _TRACEPARENT.match(str(tp).strip().lower()) if tp else None
        if rid is None and m is None and tid is None and pcls is None:
            return None
        if m is not None:
            # the sender's span becomes our parent; we are a new hop
            return cls(request_id=rid, trace_id=m.group(1),
                       parent_id=m.group(2), hop=1, tenant_id=tid,
                       priority_class=pcls, deadline_ms=dms)
        return cls(request_id=rid, tenant_id=tid, priority_class=pcls,
                   deadline_ms=dms)


def new_context(request_id=None, tenant_id=None, priority_class=None,
                deadline_ms=None) -> RequestContext:
    """Fresh hop-0 context (what a client mints once per request, BEFORE
    its retry loop — all attempts of one request share one id, one
    tenant identity, AND one QoS class/deadline)."""
    return RequestContext(request_id=request_id, tenant_id=tenant_id,
                          priority_class=priority_class,
                          deadline_ms=deadline_ms)


def current():
    """The active RequestContext for this task/thread, or None."""
    return _current.get()


@contextlib.contextmanager
def activate(ctx):
    """Scope `ctx` as the current request for the duration of the
    block (contextvar: safe under the threaded HTTP server AND under
    asyncio if serving ever grows an async front end)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def continue_from_headers(headers) -> RequestContext:
    """Server-side entry: continue the sender's context from HTTP
    headers, or mint a fresh one when the request arrived bare — every
    request has an identity from here on."""
    return RequestContext.from_headers(headers) or new_context()


@contextlib.contextmanager
def request_phase(phase, endpoint="predict", cat="serving", **extra):
    """Measure one request phase: a `serving.<phase>` span on the
    tracer (args = request identity + extras) and a
    `serving.phase_ms{phase=...,endpoint=...}` histogram observation.
    Yields the open Span (or None when tracing is off) so the caller
    can attach results computed inside the phase."""
    metrics, trace = _obs_modules()
    ctx = current()
    args = dict(ctx.trace_args() if ctx is not None else {}, **extra)
    sp = trace.begin(f"serving.{phase}", cat=cat, **args) \
        if trace is not None else None
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        dt_ms = (time.perf_counter() - t0) * 1e3
        if trace is not None:
            trace.end(sp)
        if metrics is not None:
            metrics.observe("serving.phase_ms", dt_ms, phase=str(phase),
                            endpoint=str(endpoint))
