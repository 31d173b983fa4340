"""SLO accounting: per-endpoint latency/availability objectives with a
windowed error-budget burn rate.

The signal ROADMAP item 5 (admission-aware router autoscaling against
latency SLOs) consumes: raw latency histograms say how the server IS
doing; an `SLOTracker` says how it is doing *against what was promised*
— and how fast it is spending the error budget that promise implies.

Model (the SRE-workbook shape, kept deliberately small):

  * an **objective** per endpoint: a latency target (ms) and an
    availability objective (fraction of requests that must succeed,
    e.g. 0.999 → a 0.1% error budget);
  * a sliding **window** of recent request outcomes (t, latency, ok,
    reason) — serving feeds one `observe()` per completed request and
    one `record_shed()` per admission shed (`resilience.shed_requests`
    made visible at the SLO layer, reason label preserved);
  * the **burn rate**: observed error rate over the window divided by
    the error budget.  1.0 = spending budget exactly as fast as the
    objective allows; 14.4 = the classic page-now threshold (a 30-day
    budget gone in ~2 days).  A router can scale on it, a human can
    alert on it.

`report()` returns one JSON-ready dict (embedded in serving's
`GET /debug/telemetry` and in the periodic telemetry dumps the fleet
aggregator rolls up) and publishes `slo.*` gauges on the shared
registry so the burn rate also rides the `/metrics` scrape plane.

stdlib-only; clock injectable so tests drive the window without
sleeping.
"""
from __future__ import annotations

import collections
import threading
import time

__all__ = ["SLOTracker", "SCHEMA_VERSION", "DEFAULT_WINDOW_S"]

SCHEMA_VERSION = "slo/v1"
DEFAULT_WINDOW_S = 300.0

# burn-rate severity rungs (multiples of "exactly on budget"): rendered
# in the report so dashboards and the chaos gate read one field instead
# of re-deriving thresholds
_BURN_FAST = 14.4   # 30-day budget in ~2 days — page
_BURN_SLOW = 3.0    # 30-day budget in ~10 days — ticket


def _metrics_module():
    try:
        from . import metrics  # type: ignore

        return metrics
    except ImportError:
        return None


class _Objective:
    __slots__ = ("latency_target_ms", "availability")

    def __init__(self, latency_target_ms, availability):
        self.latency_target_ms = float(latency_target_ms)
        if not 0.0 < float(availability) < 1.0:
            raise ValueError(
                f"availability objective must be in (0, 1), got "
                f"{availability!r} (1.0 leaves a zero error budget — "
                f"burn rate would be undefined)")
        self.availability = float(availability)


class SLOTracker:
    """Windowed SLO ledger.  Thread-safe (the serving handler threads
    all feed one tracker); bounded (`max_events` per endpoint caps
    memory under sustained overload — the window prune handles the
    normal case)."""

    def __init__(self, window_s=DEFAULT_WINDOW_S, max_events=8192,
                 clock=time.monotonic):
        self.window_s = float(window_s)
        self.max_events = int(max_events)
        self.clock = clock
        self._lock = threading.Lock()
        self._objectives: dict = {}
        # (endpoint, class) -> _Objective: per-class promises — a class without its own objective inherits the
        # endpoint's, so per-class burn is always computable
        self._class_objectives: dict = {}
        self._events: dict = {}    # endpoint -> deque[(t, lat_ms, ok,
        #                            reason, cls)]
        self._totals: dict = {}    # endpoint -> [requests, errors] (lifetime)

    # --- configuration ------------------------------------------------------
    def objective(self, endpoint, latency_target_ms=1000.0,
                  availability=0.999, cls=None):
        """Declare (or replace) the objective for `endpoint`.  With
        `cls`, declare the objective one priority class is promised
 — classes without one inherit the endpoint
        objective.  Returns self so server constructors can chain
        declarations."""
        with self._lock:
            if cls is not None:
                self._class_objectives[(str(endpoint), str(cls))] = \
                    _Objective(latency_target_ms, availability)
            else:
                self._objectives[str(endpoint)] = _Objective(
                    latency_target_ms, availability)
            self._events.setdefault(str(endpoint), collections.deque(
                maxlen=self.max_events))
            self._totals.setdefault(str(endpoint), [0, 0])
        return self

    def endpoints(self):
        with self._lock:
            return sorted(self._objectives)

    # --- feeding ------------------------------------------------------------
    def observe(self, endpoint, latency_ms, ok=True, reason=None,
                cls=None):
        """One finished request: latency in ms (None when the request
        never ran, e.g. a shed), ok=False consumes error budget,
        `reason` labels the failure class in the report, and `cls`
        attributes the outcome to a priority class so the
        report shows WHOSE budget burned."""
        endpoint = str(endpoint)
        now = self.clock()
        with self._lock:
            q = self._events.get(endpoint)
            if q is None:
                q = self._events[endpoint] = collections.deque(
                    maxlen=self.max_events)
                self._totals[endpoint] = [0, 0]
            q.append((now, None if latency_ms is None else float(latency_ms),
                      bool(ok), None if reason is None else str(reason),
                      None if cls is None else str(cls)))
            tot = self._totals[endpoint]
            tot[0] += 1
            if not ok:
                tot[1] += 1
            self._prune_locked(endpoint, now)

    def record_shed(self, endpoint, reason, cls=None):
        """An admission shed: never ran, counts against availability,
        reason label preserved (`shed:queue_full` etc.) so the report
        says WHY the budget burned — the chaos gate asserts on this."""
        self.observe(endpoint, None, ok=False, reason=f"shed:{reason}",
                     cls=cls)

    def _prune_locked(self, endpoint, now):  # pt-lint: ok[PT102] (callers hold _lock)
        q = self._events[endpoint]
        horizon = now - self.window_s
        while q and q[0][0] < horizon:
            q.popleft()

    # --- reporting ----------------------------------------------------------
    def report(self, publish_gauges=True) -> dict:
        """One JSON-ready snapshot: per-endpoint window counts, observed
        availability, burn rate, latency percentiles vs target — plus a
        per-priority-class breakdown (`classes`) computed
        against the class objective when one is declared, the endpoint
        objective otherwise.  Also publishes `slo.*{endpoint=...}` (and
        `slo.burn_rate{endpoint=...,class=...}`) gauges unless told not
        to."""
        now = self.clock()
        out = {"schema": SCHEMA_VERSION, "window_s": self.window_s,
               "endpoints": {}}
        metrics = _metrics_module()
        with self._lock:
            endpoints = {ep: (self._objectives.get(ep),
                              list(self._events.get(ep, ())),
                              list(self._totals.get(ep, (0, 0))))
                         for ep in set(self._objectives) | set(self._events)}
            class_objectives = dict(self._class_objectives)
        for ep, (obj, events, totals) in sorted(endpoints.items()):
            events = [e for e in events if e[0] >= now - self.window_s]
            rep = _summarize(events, obj)
            rep["lifetime_requests"] = totals[0]
            rep["lifetime_errors"] = totals[1]
            classes = sorted({e[4] for e in events
                              if len(e) > 4 and e[4]})
            if classes:
                rep["classes"] = {}
                for c in classes:
                    cobj = class_objectives.get((ep, c), obj)
                    crep = _summarize(
                        [e for e in events if len(e) > 4 and e[4] == c],
                        cobj)
                    rep["classes"][c] = crep
                    if publish_gauges and metrics is not None \
                            and "burn_rate" in crep:
                        metrics.set_gauge(
                            "slo.burn_rate", crep["burn_rate"],
                            endpoint=ep, **{"class": c})
            out["endpoints"][ep] = rep
            if publish_gauges and metrics is not None:
                if "burn_rate" in rep:
                    metrics.set_gauge("slo.burn_rate", rep["burn_rate"],
                                      endpoint=ep)
                if "availability" in rep:
                    metrics.set_gauge("slo.availability",
                                      rep["availability"], endpoint=ep)
                metrics.set_gauge("slo.window_requests", rep["requests"],
                                  endpoint=ep)
        return out


def _summarize(events, obj) -> dict:
    """Window stats for one slice of events (an endpoint, or one
    priority class within it) against one objective."""
    n = len(events)
    errors = [e for e in events if not e[2]]
    by_reason: dict = {}
    for e in errors:
        key = e[3] or "error"
        by_reason[key] = by_reason.get(key, 0) + 1
    lats = sorted(e[1] for e in events if e[1] is not None)
    rep = {"requests": n, "errors": len(errors),
           "errors_by_reason": by_reason}
    if n:
        rep["availability"] = round(1.0 - len(errors) / n, 6)
    if lats:
        rep["latency_ms"] = _quantiles(lats)
    if obj is not None:
        budget = 1.0 - obj.availability
        rep["objective"] = {
            "latency_target_ms": obj.latency_target_ms,
            "availability": obj.availability,
            "error_budget": round(budget, 6)}
        if n:
            burn = (len(errors) / n) / budget
            rep["burn_rate"] = round(burn, 4)
            rep["burn_severity"] = (
                "page" if burn >= _BURN_FAST else
                "ticket" if burn >= _BURN_SLOW else "ok")
        if lats:
            within = sum(1 for v in lats
                         if v <= obj.latency_target_ms)
            rep["latency_target_met_frac"] = round(
                within / len(lats), 6)
    return rep


def _quantiles(sorted_lats) -> dict:
    try:
        from .metrics import quantile  # type: ignore
    except ImportError:  # standalone: inline the interpolated-rank math
        def quantile(vals, q):
            n = len(vals)
            pos = q * (n - 1)
            i, frac = int(pos), pos - int(pos)
            if frac == 0.0 or i + 1 >= n:
                return float(vals[min(i, n - 1)])
            return float(vals[i]) + frac * (float(vals[i + 1])
                                            - float(vals[i]))
    return {"p50": round(quantile(sorted_lats, 0.5), 3),
            "p95": round(quantile(sorted_lats, 0.95), 3),
            "p99": round(quantile(sorted_lats, 0.99), 3),
            "max": round(sorted_lats[-1], 3)}
